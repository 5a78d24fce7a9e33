#!/usr/bin/env bash
# The port's driver twins at the JAX package's canonical quality configs
# (BASELINE.md, "Regenerated canonical battery"; results_archive/*/cmd_input.txt)
# on one NVIDIA GPU, from the repository root:
#
#     bash tools/torch_quality_runs.sh [out_dir [name ...]]
#
# SR25 (seeds 0 and 1), CSL 5-fold, EXP 10 splits, zinc-cycle t0 (4000
# graphs, 400 epochs), QM9 t0 (5000 synthetic molecules, 250 epochs),
# and the OGB twin's two rows (results_archive/ogb_tri_gnn: molhiv-shaped,
# 2000 graphs, 60 epochs, dropout 0.5, triangle label, ROC-AUC;
# results_archive/ogb_tri_pcba: molpcba-shaped, 8 tasks, emb 128 x 4,
# dropout 0.3, 40 epochs, AP), the GPS rows at their configs' own
# recipes (synthetic data; results_archive/gps_{pepstruct_canonical,mnist,
# cora,pattern,malnet}): peptides-struct 600 graphs x 60 epochs (MAE),
# MNIST 600 x 60 (accuracy), cora 100 epochs (macro-F1), PATTERN 200 x 60
# (macro-F1), MalNet-Tiny 200 x 60 (accuracy), and the run_tu CV at its
# defaults on the synthetic TU set (BaselineGNN gin0 32 x 3, 10 folds x
# 100 epochs). Names after out_dir run only those rows.
# Each run's output goes to <out_dir>/<name>.log (default
# results/torch_quality); its last two lines and its wall seconds are
# printed. Exits non-zero if any run failed.
set -uo pipefail
out=${1:-results/torch_quality}
only=" ${*:2} "
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
run() {
    local name=$1
    shift
    if [[ "$only" != "  " && "$only" != *" $name "* ]]; then
        return
    fi
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
run ogb_tri_gnn escgnn_tpu_torch.run_ogb_mol --model GNN --synth_label tri \
    --num_graphs 2000 --epochs 60 --drop_ratio 0.5 \
    --res_dir "$out/ogb_tri_gnn_res" --data_dir "$out/ogb_data"
run ogb_tri_pcba escgnn_tpu_torch.run_ogb_mol --dataset ogbg-molpcba \
    --h 3 --num_layer 4 --emb_dim 128 --drop_ratio 0.3 --epochs 40 \
    --num_tasks 8 --num_graphs 1200 --synth_label tri --metric ap \
    --res_dir "$out/ogb_tri_pcba_res" --data_dir "$out/ogb_data"
gps() {
    local name=$1 cfg=$2
    shift 2
    run "$name" escgnn_tpu_torch.run_gps --cfg "configs/gps/$cfg-GPS.yaml" \
        out_dir "$out/${name}_res" dataset.dir "$out/gps_data" "$@"
}
gps gps_pepstruct peptides-struct
gps gps_mnist mnist
gps gps_cora cora
gps gps_pattern pattern
gps gps_malnet malnet
run tu_cv escgnn_tpu_torch.run_tu --data_dir "$out/TU" \
    --res_dir "$out/tu_cv_res"
exit $status
