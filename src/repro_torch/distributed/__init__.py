"""Distributed execution: the collectives over a mesh axis and gradient
compression (``collectives.py``), the data x model parallel executor of
the dense family (``parallel.py``) and the GPipe substrate
(``pipeline.py``), over ``torch.distributed``."""
