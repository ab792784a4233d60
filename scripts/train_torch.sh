#!/usr/bin/env bash
# Training launcher of the PyTorch/CUDA port: the env knobs and defaults of
# scripts/train_tpu.sh, running gaussian_splatting_tpu_torch.train_cli on
# the host's NVIDIA cards. The port runs one process a device, so a mesh of
# MESH_DATA x MESH_MODEL > 1 cards starts under
# torchrun --nproc-per-node=MESH_DATA*MESH_MODEL.
#
# Env knobs (the defaults of scripts/train_tpu.sh):
#   VIDEOS          space-separated input videos (required)
#   OUTPUT          output dir                     (default runs/$(date))
#   ITERATIONS      total train iterations         (default 300000)
#   BATCH_SIZE      views per step                 (default 4)
#   FRAME_STRIDE    SfM frame stride               (default 30)
#   INITIAL_GAUSSIANS / MAX_GAUSSIANS
#   FOCAL_35MM      35mm-equivalent focal prior    (set but empty -> the
#                   1.2*max(W,H) heuristic)
#   FOCAL_PX        focal length in pixels
#   MATCHER         sift | orb                     (default sift)
#   MESH_DATA / MESH_MODEL   device-mesh axes, one process a card
#   RESUME          checkpoint .npz to resume from
set -euo pipefail

: "${VIDEOS:?set VIDEOS to one or more video paths}"
OUTPUT="${OUTPUT:-runs/$(date +%Y%m%d_%H%M%S)}"

args=(
  --videos ${VIDEOS}
  --output "${OUTPUT}"
  --iterations "${ITERATIONS:-300000}"
  --batch-size "${BATCH_SIZE:-4}"
  --frame-stride "${FRAME_STRIDE:-30}"
  --matcher "${MATCHER:-sift}"
)
[[ -n "${INITIAL_GAUSSIANS:-}" ]] && args+=(--initial-gaussians "${INITIAL_GAUSSIANS}")
[[ -n "${MAX_GAUSSIANS:-}" ]] && args+=(--max-gaussians "${MAX_GAUSSIANS}")
# FOCAL_35MM="" means "use the pixel heuristic", unset means the default prior.
if [[ -n "${FOCAL_35MM+x}" && -n "${FOCAL_35MM}" ]]; then
  args+=(--focal-35mm "${FOCAL_35MM}")
fi
[[ -n "${FOCAL_PX:-}" ]] && args+=(--focal-px "${FOCAL_PX}")
[[ -n "${MESH_DATA:-}" ]] && args+=(--mesh-data "${MESH_DATA}")
[[ -n "${MESH_MODEL:-}" ]] && args+=(--mesh-model "${MESH_MODEL}")
[[ -n "${RESUME:-}" ]] && args+=(--resume "${RESUME}")

n_proc=$(( ${MESH_DATA:-1} * ${MESH_MODEL:-1} ))
if (( n_proc > 1 )); then
  launch=(torchrun --nproc-per-node="${n_proc}" -m gaussian_splatting_tpu_torch.train_cli)
else
  launch=(python -m gaussian_splatting_tpu_torch.train_cli)
fi

mkdir -p "${OUTPUT}"
echo "launching: ${launch[*]} ${args[*]}"
"${launch[@]}" "${args[@]}" 2>&1 | tee "${OUTPUT}/train.log"
