"""One module a model architecture, found by the configuration's
``model_type`` (``spec.architecture``): ``architectures/<model_type>.py``.
A new architecture is a new file here and its reference under
``reference/``; nothing else changes.

Each module provides:

- ``dims(hf)``: the record the harness counts with (``model.Dims``, which
  the module may extend), read from the configuration's ``config``;
- ``block_specs(m, block)``: (name, shape, fan_in) of each tensor of a
  block in the port's parameter layout, block 0 the embedding, head and
  final norm, block i + 1 layer i; fan_in None is a norm (``weights.py``
  draws, lays out and seeds them);
- ``engine_model(m)``: the port's model configuration, importing the port
  inside the function only;
- ``forward(m, block, seqs, want, device, precision)``: the plain
  reference's logits at positions ``want`` of each of ``seqs``, from the
  weights ``block(i)`` draws (``check.py``).
"""
