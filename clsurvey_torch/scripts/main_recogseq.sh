#!/usr/bin/env bash
# RecogSeq 8-task pipeline (ref:src/main_recogseq.sh:16-29).
# The port's counterpart of scripts/main_recogseq.sh: the same commands
# through clsurvey_torch.framework.main, on the card (DEVICE=cpu for the CPU).
# Usage: [DEVICE=cpu] ./clsurvey_torch/scripts/main_recogseq.sh <method> [model]
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$(pwd)${PYTHONPATH:+:$PYTHONPATH}"

METHOD="${1:-SI}"
DEVICE="${DEVICE:-cuda}"
MODEL="${2:-alexnet_pretrained}"

python -m clsurvey_torch.framework.main "$MODEL" \
  --method_name SI --ds_name recogseq --runmode first_task_basemodel_dump \
  --num_epochs 100 --batch_size 200 --gridsearch_name reproduce --device "$DEVICE"

python -m clsurvey_torch.framework.main "$MODEL" \
  --method_name "$METHOD" --ds_name recogseq \
  --num_epochs 100 --batch_size 200 --gridsearch_name reproduce --test --device "$DEVICE"
