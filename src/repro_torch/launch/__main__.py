"""Subcommand dispatch: ``python -m repro_torch.launch {tune,serve} ...``,
the reference's two commands.

The per-module entry points stay directly runnable
(``python -m repro_torch.launch.serve``); this wrapper only routes."""
from __future__ import annotations

import importlib
import sys

COMMANDS = {"tune": "repro_torch.launch.tune",
            "serve": "repro_torch.launch.serve"}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        known = ", ".join(sorted(COMMANDS))
        sys.exit(f"usage: python -m repro_torch.launch {{{known}}} [args...]")
    importlib.import_module(COMMANDS[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    main()
