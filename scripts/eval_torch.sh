#!/usr/bin/env bash
# Eval launcher of the PyTorch/CUDA port: the env knobs and defaults of
# scripts/eval_tpu.sh, running gaussian_splatting_tpu_torch.eval_cli. When
# MODEL is not given it takes the newest runs/*/final.npz or
# runs/*/checkpoint_*.npz.
#
# Env knobs: VIDEOS (required), MODEL, OUTPUT (default the model's
# directory/eval), NUM_VIEWS (default 12), FRAME_STRIDE (default 30).
set -euo pipefail

: "${VIDEOS:?set VIDEOS to the source video paths}"
if [[ -z "${MODEL:-}" ]]; then
  MODEL=$(ls -t runs/*/final.npz runs/*/checkpoint_*.npz 2>/dev/null | head -1 || true)
  [[ -n "${MODEL}" ]] || { echo "no checkpoint found under runs/"; exit 1; }
  echo "auto-discovered model: ${MODEL}"
fi
OUTPUT="${OUTPUT:-$(dirname "${MODEL}")/eval}"

exec python -m gaussian_splatting_tpu_torch.eval_cli \
  --model "${MODEL}" \
  --videos ${VIDEOS} \
  --output "${OUTPUT}" \
  --num-views "${NUM_VIEWS:-12}" \
  --frame-stride "${FRAME_STRIDE:-30}"
