#!/usr/bin/env bash
# Launch the port's training on every node of a Slurm allocation of GPU
# nodes: the counterpart of launch/tpu_pod_run.sh, and the reference's
# Slurm + torchrun launcher. srun starts one torch.distributed.run agent per
# node; each agent forks one rank per GPU of its node, and the agents meet
# at a c10d rendezvous on the allocation's first node. The ranks read
# RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT from the agent
# (parallel/distributed.py) and train over NCCL, one GPU each.
#
# Usage (from the repository root, on a shared filesystem):
#   sbatch mingpt_distributed_tpu_torch/launch/slurm_run.sh [train args...]
# Example:
#   sbatch --nodes 4 mingpt_distributed_tpu_torch/launch/slurm_run.sh \
#       --config gpt2_config.yaml trainer_config.mesh.dp=32
#
# The ranks per node are the GPUs Slurm gave each node
# (SLURM_GPUS_ON_NODE). RDZV_PORT (default 29500) is the rendezvous port on
# the first node. Arguments after the script's name go to
# mingpt_distributed_tpu_torch.train, after --dist-backend nccl (a later
# --dist-backend wins).
#
#SBATCH --job-name=mingpt
#SBATCH --nodes=2
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node=8
#SBATCH --cpus-per-task=32

set -euo pipefail

: "${SLURM_JOB_NODELIST:?run under sbatch or salloc}"
# the whole list first: under pipefail, `| head -n 1` could end scontrol
# with SIGPIPE and the script with it
NODES="$(scontrol show hostnames "$SLURM_JOB_NODELIST")"
HEAD_NODE="${NODES%%$'\n'*}"
GPUS_PER_NODE="${SLURM_GPUS_ON_NODE:?no GPUs in the allocation (sbatch --gpus-per-node)}"
RDZV_PORT="${RDZV_PORT:-29500}"
export LOGLEVEL="${LOGLEVEL:-INFO}"   # reference parity: slurm_run.sh:15

srun python -m torch.distributed.run \
  --nnodes "$SLURM_NNODES" \
  --nproc-per-node "$GPUS_PER_NODE" \
  --rdzv-backend c10d \
  --rdzv-endpoint "$HEAD_NODE:$RDZV_PORT" \
  --rdzv-id "$SLURM_JOB_ID" \
  -m mingpt_distributed_tpu_torch.train --dist-backend nccl "$@"
