#!/usr/bin/env bash
# Tiny-ImageNet 10-task pipeline (ref:src/main_tinyimagenet.sh:16-39).
# The port's counterpart of scripts/main_tinyimagenet.sh: the same commands
# through clsurvey_torch.framework.main, on the card (DEVICE=cpu for the CPU).
# Usage: [DEVICE=cpu] ./clsurvey_torch/scripts/main_tinyimagenet.sh <method> [model]
#   1) dump the shared SI first-task base model (once)
#   2) run the requested method over the sequence + evaluate
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$(pwd)${PYTHONPATH:+:$PYTHONPATH}"

METHOD="${1:-SI}"
DEVICE="${DEVICE:-cuda}"
MODEL="${2:-small_VGG9_cl_128_128}"
DS=tiny
EPOCHS=70
BS=200
LR_GRID="1e-2,5e-3,1e-3,5e-4,1e-4"
BOOT_LR_GRID="1e-1,5e-2,1e-2,5e-3,1e-3,5e-4,1e-4"
GRID=reproduce

python -m clsurvey_torch.framework.main "$MODEL" \
  --method_name SI --ds_name "$DS" --runmode first_task_basemodel_dump \
  --num_epochs "$EPOCHS" --batch_size "$BS" \
  --lr_grid "$LR_GRID" --boot_lr_grid "$BOOT_LR_GRID" \
  --gridsearch_name "$GRID" --device "$DEVICE"

python -m clsurvey_torch.framework.main "$MODEL" \
  --method_name "$METHOD" --ds_name "$DS" \
  --num_epochs "$EPOCHS" --batch_size "$BS" \
  --lr_grid "$LR_GRID" --boot_lr_grid "$BOOT_LR_GRID" \
  --gridsearch_name "$GRID" --test --device "$DEVICE"
