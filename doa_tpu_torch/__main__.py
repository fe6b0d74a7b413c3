"""``python -m doa_tpu_torch <cmd>``: the command-line apps (cli.py).
Importing this module runs nothing."""

from doa_tpu_torch.cli import main

if __name__ == "__main__":
    main()
