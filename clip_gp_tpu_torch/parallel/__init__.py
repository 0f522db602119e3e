"""The sweep runner (``sweep.py``) and its trial-batched backend
(``trial_vmap.py``)."""
