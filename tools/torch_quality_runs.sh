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
# 100 epochs). The zoo rows (BASELINE.md's flagship, copy-family, zoo
# and GPS rows; each at its JAX record's flags from
# results_archive/<dir>/cmd_input.txt): zinc (the flagship, 8000 graphs x
# 800 epochs), zc_ngnn and zc_i2gnn (zinc-cycle t0, 4000 x 200), qm9_k123
# (5000 x 250), ogb_tri_ginep and ogb_tri_nppgn (molhiv-shaped tri, 2000
# x 60), gps_zinc (4000 x 300), gps_pepstruct_full (2400 x 200),
# gps_aqsol (its config's 512 x 50) and count_ppgn (PPGN_eff on
# count_cycle t0, 1500 x 800). Names after out_dir run only those rows.
# Each run's output goes to <out_dir>/<name>.log (default
# results/torch_quality); its last two lines and its wall seconds are
# printed. With SEED=<n> in the environment every row runs at seed n
# (`--seed n`; `seed n` for GPS) into <out_dir>/<name>_s<n>.log and
# <name>_s<n>_res. With INIT=<npz> (`tools/carry_jax_init.py dump` of
# the JAX driver at the row's flags and seed) a driver row starts from
# those weights (`tools/carry_jax_init.py run`) and its log and results
# get `_jaxinit` before the seed tag. Exits non-zero if any run failed.
set -uo pipefail
out=${1:-results/torch_quality}
only=" ${*:2} "
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
seed=${SEED:-}
init=${INIT:-}
tag=${init:+_jaxinit}${seed:+_s$seed}
run() {
    local name=$1
    shift
    if [[ "$only" != "  " && "$only" != *" $name "* ]]; then
        return
    fi
    local t0=$SECONDS
    local extra=()
    if [[ -n "$seed" ]]; then
        if [[ "$1" == escgnn_tpu_torch.run_gps ]]; then
            extra=(seed "$seed")
        else
            extra=(--seed "$seed")
        fi
    fi
    local cmd=(-m "$@")
    if [[ -n "$init" ]]; then
        cmd=(tools/carry_jax_init.py run "$init" "${1#escgnn_tpu_torch.}"
             -- "${@:2}")
    fi
    if ! python3 "${cmd[@]}" "${extra[@]}" > "$out/$name$tag.log" 2>&1; then
        echo "$name FAILED"
        status=1
    fi
    tail -n 2 "$out/$name$tag.log"
    echo "$name wall $((SECONDS - t0)) s"
}
run sr escgnn_tpu_torch.run_sr
run sr_seed1 escgnn_tpu_torch.run_sr --seed 1
run csl escgnn_tpu_torch.run_csl --folds 5
run exp escgnn_tpu_torch.run_exp --splits 10
run zinc_cycle escgnn_tpu_torch.run_zinc_cycle --h 3 --target 0 \
    --num_graphs 4000 --epochs 400 --res_dir "$out/zinc_cycle${tag}_res"
run qm9 escgnn_tpu_torch.run_qm9 --target 0 --num_graphs 5000 \
    --epochs 250 --res_dir "$out/qm9${tag}_res" --data_dir "$out/qm9_data"
run ogb_tri_gnn escgnn_tpu_torch.run_ogb_mol --model GNN --synth_label tri \
    --num_graphs 2000 --epochs 60 --drop_ratio 0.5 \
    --res_dir "$out/ogb_tri_gnn${tag}_res" --data_dir "$out/ogb_data"
run ogb_tri_pcba escgnn_tpu_torch.run_ogb_mol --dataset ogbg-molpcba \
    --h 3 --num_layer 4 --emb_dim 128 --drop_ratio 0.3 --epochs 40 \
    --num_tasks 8 --num_graphs 1200 --synth_label tri --metric ap \
    --res_dir "$out/ogb_tri_pcba${tag}_res" --data_dir "$out/ogb_data"
gps() {
    local name=$1 cfg=$2
    shift 2
    run "$name" escgnn_tpu_torch.run_gps --cfg "configs/gps/$cfg-GPS.yaml" \
        out_dir "$out/${name}${tag}_res" dataset.dir "$out/gps_data" "$@"
}
gps gps_pepstruct peptides-struct
gps gps_mnist mnist
gps gps_cora cora
gps gps_pattern pattern
gps gps_malnet malnet
run tu_cv escgnn_tpu_torch.run_tu --data_dir "$out/TU" \
    --res_dir "$out/tu_cv${tag}_res"
run zinc escgnn_tpu_torch.run_zinc --layers 5 --lr 5e-4 --num_graphs 8000 \
    --epochs 800 --res_dir "$out/zinc${tag}_res" --data_dir "$out/zinc_data"
run zc_ngnn escgnn_tpu_torch.run_zinc_cycle --model NGNN --target 0 \
    --num_graphs 4000 --epochs 200 --lr 1e-3 --res_dir "$out/zc_ngnn${tag}_res"
run zc_i2gnn escgnn_tpu_torch.run_zinc_cycle --model I2GNN --target 0 \
    --num_graphs 4000 --epochs 200 --lr 1e-3 \
    --res_dir "$out/zc_i2gnn${tag}_res"
run qm9_k123 escgnn_tpu_torch.run_qm9 --model k123_GNN --target 0 \
    --num_graphs 5000 --epochs 250 --res_dir "$out/qm9_k123${tag}_res" \
    --data_dir "$out/qm9_data"
run ogb_tri_ginep escgnn_tpu_torch.run_ogb_mol --model GINEPlus \
    --synth_label tri --num_graphs 2000 --epochs 60 --emb_dim 100 \
    --drop_ratio 0.2 --multihop_k 3 --res_dir "$out/ogb_tri_ginep${tag}_res" \
    --data_dir "$out/ogb_data"
run ogb_tri_nppgn escgnn_tpu_torch.run_ogb_mol --model NestedPPGN \
    --synth_label tri --num_graphs 2000 --epochs 60 --emb_dim 64 \
    --num_layer 2 --h 3 --drop_ratio 0.2 \
    --res_dir "$out/ogb_tri_nppgn${tag}_res" --data_dir "$out/ogb_data"
gps gps_zinc zinc dataset.num_graphs 4000 train.epochs 300
gps gps_pepstruct_full peptides-struct dataset.num_graphs 2400 \
    train.epochs 200
gps gps_aqsol aqsol
run count_ppgn escgnn_tpu_torch.run_graphcount --model PPGN_eff --target 0 \
    --h 3 --batch_size 128 --lr 5e-3 --epochs 800 --num_graphs 1500 \
    --num_workers 2 --res_dir "$out/count_ppgn${tag}_res" \
    --data_dir "$out/count_data"
clip() {
    local name=$1
    shift
    run "$name" escgnn_tpu_torch.run_graphcount "$@" --batch_size 128 \
        --lr 2e-3 --lr_decay_factor 0.7 --patience 20 --grad_clip 1.0 \
        --num_graphs 5000 --num_workers 2 --res_dir "$out/${name}${tag}_res" \
        --data_dir "$out/${name}_data"
}
clip count_ppgn_clip_t0 --model PPGN_eff --target 0 --h 3 --epochs 487
clip count_ppgn_clip_t1 --model PPGN_eff --target 1 --h 3 --epochs 858
clip cgra_ppgn_clip_t0 --dataset count_graphlet --model PPGN_eff --target 0 \
    --h 1 --epochs 800
exit $status
