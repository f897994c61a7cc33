#!/bin/bash
# The full-budget flagship quality run of the PyTorch port: the
# reference's 50k-step training budget (opt2.py:66) at the flagship batch,
# through the whole pipeline (train -> evaluation -> regional tables),
# under the stall watchdog with resume.  Its run directory is what
# `python -m season_nerf_torch.tools.quality_report` turns into tables.
# The counterpart of tools/run_flagship.sh, with its arguments.
#
#   bash season_nerf_torch/tools/run_flagship.sh [IO_LOCATION] [SEED] \
#       [EXTRA FLAGS...]
#
# e.g.:
#   bash season_nerf_torch/tools/run_flagship.sh /tmp/flagship_r3 0 \
#       --compute_dtype float32
#   bash season_nerf_torch/tools/run_flagship.sh /tmp/flagship_bf16 0
# Extra flags go to `cli train` (--pallas_trunk, --device cpu, ...).
set -e
IO=${1:-/tmp/flagship_r3}
SEED=${2:-0}
shift $(( $# > 2 ? 2 : $# ))
EXP=flagship_s${SEED}
cd "$(dirname "$0")/../.."
exec python -m season_nerf_torch.tools.watchdog_train \
    --logs_dir "$IO/Logs/$EXP" \
    --stall_sec 900 --grace_sec 1800 --max_restarts 8 -- \
    python -m season_nerf_torch.cli train --site_name SYNTH_FLAGSHIP \
    --exp_name "$EXP" --IO_Location "$IO" --max_train_steps 50000 \
    --batch_size 2048 --n_samples 96 --fc_units 512 --synth_views 14 \
    --testing_size 3 --n_saves 20 --seed "$SEED" "$@"
