#!/usr/bin/env bash
# iNaturalist 10-supercategory pipeline (ref:src/main_inaturalist.sh:16-26).
# The port's counterpart of scripts/main_inaturalist.sh: the same commands
# through clsurvey_torch.framework.main, on the card (DEVICE=cpu for the CPU).
# Usage: [DEVICE=cpu] ./clsurvey_torch/scripts/main_inaturalist.sh <method> [model]
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$(pwd)${PYTHONPATH:+:$PYTHONPATH}"

METHOD="${1:-SI}"
DEVICE="${DEVICE:-cuda}"
MODEL="${2:-alexnet_pretrained}"

python -m clsurvey_torch.framework.main "$MODEL" \
  --method_name SI --ds_name inat --runmode first_task_basemodel_dump \
  --num_epochs 70 --batch_size 200 --gridsearch_name reproduce --device "$DEVICE"

python -m clsurvey_torch.framework.main "$MODEL" \
  --method_name "$METHOD" --ds_name inat \
  --num_epochs 70 --batch_size 200 --gridsearch_name reproduce --test --device "$DEVICE"
