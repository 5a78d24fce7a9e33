#!/usr/bin/env bash
# The port's driver twins at the JAX package's canonical quality configs
# (BASELINE.md, "Regenerated canonical battery"; results_archive/*/cmd_input.txt)
# on one NVIDIA GPU, from the repository root:
#
#     bash tools/torch_quality_runs.sh [out_dir]
#
# SR25 (seeds 0 and 1), CSL 5-fold, EXP 10 splits, zinc-cycle t0 (4000
# graphs, 400 epochs) and QM9 t0 (5000 synthetic molecules, 250 epochs).
# Each run's output goes to <out_dir>/<name>.log (default
# results/torch_quality); its last two lines and its wall seconds are
# printed. Exits non-zero if any run failed.
set -uo pipefail
out=${1:-results/torch_quality}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
run() {
    local name=$1
    shift
    local t0=$SECONDS
    if ! python3 -m "$@" > "$out/$name.log" 2>&1; then
        echo "$name FAILED"
        status=1
    fi
    tail -n 2 "$out/$name.log"
    echo "$name wall $((SECONDS - t0)) s"
}
run sr escgnn_tpu_torch.run_sr
run sr_seed1 escgnn_tpu_torch.run_sr --seed 1
run csl escgnn_tpu_torch.run_csl --folds 5
run exp escgnn_tpu_torch.run_exp --splits 10
run zinc_cycle escgnn_tpu_torch.run_zinc_cycle --h 3 --target 0 \
    --num_graphs 4000 --epochs 400 --res_dir "$out/zinc_cycle_res"
run qm9 escgnn_tpu_torch.run_qm9 --target 0 --num_graphs 5000 \
    --epochs 250 --res_dir "$out/qm9_res" --data_dir "$out/qm9_data"
exit $status
