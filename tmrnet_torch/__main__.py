"""`python -m tmrnet_torch <command>`: see `tmrnet_torch/cli.py`."""

from tmrnet_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
