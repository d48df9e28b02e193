#!/usr/bin/env sh
# TetraEar quick launcher for the PyTorch / CUDA port: starts the port's
# interactive terminal UI on its --device default (cuda; without a card
# the command exits naming --device cpu).  Any `tetraear_tpu_torch tui`
# flags pass through, e.g.:
#
#   ./run_tetraear_torch.sh -f 392.225 --synthetic
#   ./run_tetraear_torch.sh --iq-file capture.cf32 --no-afc
#   ./run_tetraear_torch.sh --iq-file capture.cf32 --device cpu
cd "$(dirname "$0")" || exit 1
exec python -m tetraear_tpu_torch tui "$@"
