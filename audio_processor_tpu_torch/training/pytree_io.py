"""Flat ``.npz`` (de)serialisation of the trainers' parameter trees.

The port of the JAX package's ``training/pytree_io.py``: nested dicts and
lists flatten to ``.``-joined keys; on the way back, dicts whose keys are
all digits become lists again.  bf16 leaves are widened to float32, since
``np.savez`` has no bfloat16.  Both live beside the diarizer's readers
(``models/diarization/checkpoint.py``), which serve the same files.
"""
from ..models.diarization.checkpoint import flatten_tree, unflatten_tree  # noqa: F401
