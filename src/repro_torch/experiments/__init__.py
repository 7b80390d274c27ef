"""Torch twins of the paper's experiment scripts (benchmarks/fig4_convergence,
fig5_denoise, table3_auc, table4_auc_huber), each runnable as
`python -m repro_torch.experiments.<name> [--device cpu]`."""
