"""The BladeRF devices on this host (the port's copy of
tools/list_bladerf_devices.py: the port's `devices` command; host only).

    python -m tetraear_tpu_torch.tools.list_bladerf_devices
"""

from __future__ import annotations


def main(argv=None) -> int:
    from tetraear_tpu_torch.ui.cli import cmd_devices
    return cmd_devices(argv)


if __name__ == "__main__":
    raise SystemExit(main())
