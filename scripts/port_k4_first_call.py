"""The RoIAlign kernel's first call on a card: build the port's kernels,
print what ptxas reports, hold K4 against its plain version at the main
path's shapes (chip_smoke.py's phase 3 for K4 alone), and stop.

    python3 scripts/port_k4_first_call.py

Run it from the root of the checkout. Exits non-zero if the kernel does
not build, does not launch or disagrees."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

if __name__ == '__main__':
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    print(chip_smoke.phase_k4())
