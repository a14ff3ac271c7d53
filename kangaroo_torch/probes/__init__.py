"""On-card probes of the walk kernel's parts, one module per TPU probe
script of the JAX package (scripts/pkbench.py, probe_ops.py, pkdelta.py,
pkinv.py, layout_probe.py), with the same positional arguments and
output lines:

    python -m kangaroo_torch.probes.pkbench [lanes_log2=22]
    python -m kangaroo_torch.probes.probe_ops
    python -m kangaroo_torch.probes.pkdelta [herd_log2=22] [nb_run=64] [variants]
    python -m kangaroo_torch.probes.pkinv [W_log2=22] [iters=64] [variants]
    python -m kangaroo_torch.probes.layout_probe [W=4096] [iters=131072] [variants]

They run only on a CUDA card; the kernels are `csrc/probe_kernels.cu`.
"""
