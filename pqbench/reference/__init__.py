"""The plain reference that judges the program's answers.

Plain torch and NumPy, with TF32 off. It imports neither JAX, nor the JAX
package, nor anything of the program (``pqvector_tpu_torch``), and takes
nothing the program made: it works from the rows the benchmark drew, the
benchmark's own coarse index, and the bytes the program wrote to the file.
"""

import torch


def no_tf32() -> None:
    """f32 matmuls in IEEE fp32: TF32 would round each operand to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
