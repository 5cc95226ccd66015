"""``python -m roomnet_tpu_torch <subcommand>``: the port's CLI (cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
