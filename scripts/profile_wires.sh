#!/bin/bash
# Where a join's device time goes on each shuffle wire of the port, over
# NCCL, one process a card on every card of the machine: the config
# driver's --profile 3 (torch.profiler on rank 0) at BASELINE config 2's
# shape (10 M x 10 M rows a rank, over-decomposition 4) on the padded,
# ragged, ppermute and compressed (32-bit) wires, and config 5 (5 M x 5 M
# rows a rank) on the padded and ragged wires, fixed and variable-length
# strings. One JSON record a line on stdout, each after a "# <wire>" line.
#
#   bash scripts/profile_wires.sh            # from the root of a checkout
set -euo pipefail
cd "$(dirname "$0")/.."
n=$(python -c 'import torch; print(torch.cuda.device_count())')
rows=$((10000000 * n))
c5=$((5000000 * n))
drv=(-m distributed_join_tpu_torch.benchmarks.distributed_join
     --communicator nccl --over-decomposition-factor 4 --profile 3)
run() {
  echo "# $1"
  shift
  python -m distributed_join_tpu_torch.benchmarks.launch --num-processes "$n" \
    -- python "${drv[@]}" "$@"
}
c2=(--build-table-nrows "$rows" --probe-table-nrows "$rows")
c5f=(--build-table-nrows "$c5" --probe-table-nrows "$c5" --key-columns 2
     --string-payload-bytes 16)
run padded "${c2[@]}"
run ragged "${c2[@]}" --shuffle ragged
run ppermute "${c2[@]}" --shuffle ppermute
run compressed32 "${c2[@]}" --compression --compression-bits 32
run config5_padded "${c5f[@]}"
run config5_ragged "${c5f[@]}" --shuffle ragged
run config5_ragged_varlen "${c5f[@]}" --shuffle ragged --variable-length-strings
