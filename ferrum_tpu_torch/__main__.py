"""`python -m ferrum_tpu_torch <subcommand>` (see cli.py)."""

if __name__ == "__main__":
    from .cli import main

    raise SystemExit(main())
