"""``python -m pqbench``: the same as ``python3 pqbench/run.py``."""

from pqbench.run import main

if __name__ == "__main__":
    raise SystemExit(main())
