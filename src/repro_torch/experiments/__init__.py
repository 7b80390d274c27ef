"""Torch twins of the paper's experiment scripts (benchmarks/fig4_convergence,
fig5_denoise, table3_auc, table4_auc_huber) and of every example script
(examples/quickstart, denoise_image, novel_docs, graph_gossip, multi_pod,
streaming_quickstart, train_lm), each runnable as
`python -m repro_torch.experiments.<name> [--device cpu]`."""
