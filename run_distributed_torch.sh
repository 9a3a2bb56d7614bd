#!/usr/bin/env bash
# run_distributed_torch.sh - launch train_torch.py over a cluster, one
# process per device (the twin of run_distributed.sh for the PyTorch port).
#
# Local fan-out: N processes on this host, ranks 0..N-1, each on
# cuda:<rank> (or on the CPU with --device cpu --dist-backend gloo):
#   ./run_distributed_torch.sh -n 4 -- --workload gpt_lm --steps 50
#   ./run_distributed_torch.sh -n 2 -- --workload gpt_lm --test-size \
#       --device cpu --dist-backend gloo --steps 3
#
# Multi-host (run on every host, one process per task):
#   COORDINATOR=host0:12321 NPROC=16 RANK=$I ./run_distributed_torch.sh -- ...
#
# Under Slurm/MPI no flags are needed: train_torch.py's resolver chain
# picks the cluster up from the scheduler env (SLURM_*/OMPI_*).  The
# cluster reaches train_torch.py as torchrun's variables: RANK,
# WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK.
set -euo pipefail

NPROC_LOCAL=""
PORT=12321
ARGS=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    -n|--nproc) NPROC_LOCAL="$2"; shift 2 ;;
    -p|--port) PORT="$2"; shift 2 ;;
    --) shift; ARGS=("$@"); break ;;
    *) ARGS+=("$1"); shift ;;
  esac
done

if [[ -n "$NPROC_LOCAL" ]]; then
  # one intra-op thread a process unless the caller says otherwise (as
  # torchrun does): N processes of all-core pools would oversubscribe
  pids=()
  trap 'kill "${pids[@]}" 2>/dev/null || true' EXIT
  for ((i = 0; i < NPROC_LOCAL; i++)); do
    OMP_NUM_THREADS="${OMP_NUM_THREADS:-1}" \
    MASTER_ADDR=127.0.0.1 \
    MASTER_PORT="$PORT" \
    WORLD_SIZE="$NPROC_LOCAL" \
    RANK="$i" \
    LOCAL_RANK="$i" \
    LOCAL_WORLD_SIZE="$NPROC_LOCAL" \
      python "$(dirname "$0")/train_torch.py" "${ARGS[@]}" &
    pids+=($!)
  done
  status=0
  for pid in "${pids[@]}"; do
    wait "$pid" || status=$?
  done
  trap - EXIT
  exit "$status"
fi

if [[ -n "${COORDINATOR:-}" ]]; then
  export MASTER_ADDR="${COORDINATOR%:*}"
  export MASTER_PORT="${COORDINATOR##*:}"
  export WORLD_SIZE="${NPROC:?set NPROC with COORDINATOR}"
  export RANK="${RANK:?set RANK with COORDINATOR}"
fi
exec python "$(dirname "$0")/train_torch.py" "${ARGS[@]}"
