"""K9 (``pqvector_tpu_torch/kernels/tilemin.py``) against the JAX package's
``pallas_tile_min`` in interpret mode, on the CPU (the plain version), and
the kernel against its plain version on the card.

Tolerance: values within ``max(d, 128) * 2^-21 * (|q|^2 + max |x|^2)``, the
certificate's own envelope, because the two matrix products sum in other
orders. Pad-only tiles must return their sentinel exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqvector_tpu.kernels.tilemin import pallas_tile_min
from pqvector_tpu_torch.kernels import _build
from pqvector_tpu_torch.kernels.tilemin import tile_min, tile_min_plain


def _data(n_pad, d, b, seed, pad=137, sentinel=np.inf):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    x[-pad:] = 0.0
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    sq[-pad:] = sentinel
    q = rng.standard_normal((b, d)).astype(np.float32)
    return x, sq, q


def _envelope(q, sq, d):
    fin = sq[sq < 1e38]
    return max(d, 128) * 2.0**-21 * ((q * q).sum(1).max() + fin.max())


def _jax(x, sq, q, tile, dtype=jnp.float32, high=False):
    return np.asarray(pallas_tile_min(
        jnp.asarray(q), jnp.asarray(x, dtype), jnp.asarray(sq), tile, high=high,
        interpret=True,
    ))


def _port(x, sq, q, tile, dtype=torch.float32, high=False):
    return tile_min(torch.from_numpy(q), torch.from_numpy(x).to(dtype),
                    torch.from_numpy(sq), tile, high=high).numpy()


@pytest.mark.parametrize("sentinel", [np.inf, 3.0e38])
@pytest.mark.parametrize("b", [1, 7, 24])
@pytest.mark.parametrize("tile,n_pad,d", [(128, 4096, 64), (256, 2048, 40), (512, 1024, 96)])
def test_matches_jax_f32(tile, n_pad, d, b, sentinel):
    x, sq, q = _data(n_pad, d, b, seed=tile + b, sentinel=sentinel)
    want, got = _jax(x, sq, q, tile), _port(x, sq, q, tile)
    assert got.shape == (b, n_pad // tile) and got.dtype == np.float32
    fin = want < 1e38
    np.testing.assert_array_equal(got < 1e38, fin)
    assert np.abs(got - want)[fin].max() <= _envelope(q, sq, d)
    if tile <= 128:  # 137 pad rows fill the last tile
        assert (got[:, -1] == np.float32(sentinel)).all()


@pytest.mark.parametrize("high", [False, True])
def test_matches_jax_bf16_and_high(high):
    """bf16 storage: both widen exact bf16 products into f32 sums. ``high``
    moves only the TPU's f32 product; the port ignores it."""
    x, sq, q = _data(2048, 64, 9, seed=5)
    want = _jax(x, sq, q, 128, jnp.bfloat16, high=high)
    got = _port(x, sq, q, 128, torch.bfloat16, high=high)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got - want)[fin].max() <= _envelope(q, sq, 64)
    np.testing.assert_array_equal(got, _port(x, sq, q, 128, torch.bfloat16))


@pytest.mark.parametrize("tile", [2, 8, 32, 64, 2048])
def test_every_power_of_two_tile_matches_numpy(tile):
    """The TPU kernel takes multiples of 128 only; the port takes every
    power of two (cert's auto rule shrinks the tile on tiny arrays)."""
    x, sq, q = _data(4096, 24, 5, seed=tile, pad=70)
    got = _port(x, sq, q, tile)
    part = sq[None, :].astype(np.float64) - 2.0 * q.astype(np.float64) @ x.T.astype(np.float64)
    want = part.reshape(5, -1, tile).min(2)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got - want)[fin].max() <= _envelope(q, sq, 24)


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(tile=96), ValueError),  # not a power of two
        (dict(tile=1), ValueError),
        (dict(tile=8192), ValueError),  # does not divide n_pad
        (dict(q_dtype=torch.float64), TypeError),
        (dict(emb_dtype=torch.float16), TypeError),
        (dict(sq_rows=100), TypeError),
    ],
)
def test_wrapper_rejects_bad_operands(kw, err):
    q = torch.zeros(3, 16, dtype=kw.get("q_dtype", torch.float32))
    emb = torch.zeros(4096, 16, dtype=kw.get("emb_dtype", torch.float32))
    sq = torch.zeros(kw.get("sq_rows", 4096))
    with pytest.raises(err):
        tile_min(q, emb, sq, kw.get("tile", 128))


def test_cpu_call_launches_nothing():
    x, sq, q = _data(1024, 16, 2, seed=1)
    before = _build.LAUNCHES["K9"]
    _port(x, sq, q, 128)
    assert _build.LAUNCHES["K9"] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [2, 64, 128, 1024])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tile):
    x, sq, q = _data(8192, 100, 37, seed=tile, pad=1100)
    args = (torch.from_numpy(q).to(cuda_device),
            torch.from_numpy(x).to(cuda_device).to(dtype),
            torch.from_numpy(sq).to(cuda_device), tile)
    before = _build.LAUNCHES["K9"]
    got = tile_min(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K9"] == before + 1
    want = tile_min_plain(*args)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert float((got - want)[fin].abs().max()) <= _envelope(q, sq, 100)
