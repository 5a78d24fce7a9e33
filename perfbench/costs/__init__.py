"""Analytic FLOPs of one configuration's training (forward and backward):
`perfbench/costs/<config>.py` exposes `flops(sizes, fields, launched=False)`.

`sizes` holds `graphs` and, per graph, `nodes`, `edges` (self-loops
included) and `nnz` (ESC nonzeros). A product counts 2 FLOPs per multiply-
add; training counts each product's forward, its weight gradient and its
input gradient where the input depends on a parameter. Dense layers, 1x1
convolutions and PPGN's block products count in full at the real sizes; a
sparse product (the ESC count rows times the z table, a gather or sum of
rows by an edge list) counts its nonzeros.

`launched=True` counts instead what the system launches as matrix products
at padded sizes (`sizes` then also holds the batch's budgets): each sparse
product at the dense shape the system gives it, and none where the system
computes it without a matrix product. It exists to hold the dense terms to
`torch.utils.flop_counter.FlopCounterMode`'s count of one eager step."""
