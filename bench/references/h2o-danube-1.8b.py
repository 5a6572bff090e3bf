"""h2o-danube-1.8b runs the dense decoder of ``bench/reference.py``,
``bench/data.py`` and ``bench/flops.py``; this file gives only its sizes in the
CPU tests (the window shorter than their prompts)."""

SMALL = dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
             vocab_size=2048, sliding_window=16)
