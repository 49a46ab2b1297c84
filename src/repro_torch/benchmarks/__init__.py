"""The paper's figures on the port: spectral gaps (Fig. 3 / Table 5),
consensus residues (Figs. 4/10/11), transient iterations (Figs. 1/13)
and the heterogeneity and straggler ablation (eq. 4).  Run them with
``python -m repro_torch.benchmarks.run``."""
