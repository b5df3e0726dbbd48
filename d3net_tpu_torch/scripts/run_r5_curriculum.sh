#!/bin/bash
# Round-5 curriculum on the card (the JAX package's scripts/run_r5_curriculum.sh):
# detector -> speaker -> listener -> joint RL v2 (multi-ref CIDEr + XE anchor),
# then stage evals.  Stage weights hand off via prepare_weights pickles (the
# reference's stage-wise pretrained/*.pth flow), which either package reads.
# Runs the stages one after another; each train and eval uses every usable
# card.  Run from anywhere: it changes to the repo root, where the configs'
# outputs/ and pretrained/ paths resolve.
set -x
cd "$(dirname "$0")/../.."

DET_STEPS=${DET_STEPS:-576}
SPK_STEPS=${SPK_STEPS:-128}
LIS_STEPS=${LIS_STEPS:-128}
JOINT_STEPS=${JOINT_STEPS:-48}

python -m d3net_tpu_torch.scripts.train --config conf/det_converge.yaml \
    --folder det_converge_r5 --max_steps "$DET_STEPS" || exit 1
python -m d3net_tpu_torch.scripts.prepare_weights --folder outputs/det_converge_r5 \
    --name det_converge --which best || exit 1

python -m d3net_tpu_torch.scripts.train --config conf/spk_converge.yaml \
    --folder spk_converge_r5 --max_steps "$SPK_STEPS" || exit 1
python -m d3net_tpu_torch.scripts.eval --folder outputs/spk_converge_r5 --task captioning
python -m d3net_tpu_torch.scripts.prepare_weights --folder outputs/spk_converge_r5 \
    --name spk_converge --which best || exit 1

python -m d3net_tpu_torch.scripts.train --config conf/lis_converge.yaml \
    --folder lis_converge_r5 --max_steps "$LIS_STEPS" || exit 1
python -m d3net_tpu_torch.scripts.eval --folder outputs/lis_converge_r5 --task grounding
python -m d3net_tpu_torch.scripts.prepare_weights --folder outputs/lis_converge_r5 \
    --name lis_converge --which best || exit 1

python -m d3net_tpu_torch.scripts.train --config conf/joint_converge.yaml \
    --folder joint_converge_r5 --max_steps "$JOINT_STEPS" || exit 1
python -m d3net_tpu_torch.scripts.eval --folder outputs/joint_converge_r5 --task captioning
python -m d3net_tpu_torch.scripts.eval --folder outputs/joint_converge_r5 --task grounding
echo CURRICULUM DONE
