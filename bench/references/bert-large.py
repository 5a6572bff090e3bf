"""bert-large runs the dense decoder of ``bench/reference.py``, ``bench/data.py``
and ``bench/flops.py``; this file gives only its sizes in the CPU tests."""

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
             vocab_size=256)
