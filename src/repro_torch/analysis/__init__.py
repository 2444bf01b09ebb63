"""aamlint — wave-safety static analysis + runtime conflict sanitizer of
the PyTorch port.

The paper's HTM gives serializability of atomic active messages in
hardware; the software port only inherits the guarantee when every
commit site obeys three preconditions that hardware enforced implicitly:

* the commit op is reorder-safe (commutative/associative, idempotent
  where a message can be delivered more than once) — checked by
  :mod:`repro_torch.analysis.algebra`;
* composite batch-axis keys are disjoint and fit the key dtype —
  checked by :mod:`repro_torch.analysis.keyspace`;
* no round writes round state outside ``commit()``'s conflict
  resolution — checked by :mod:`repro_torch.analysis.waverace` over the
  ops :mod:`repro_torch.analysis.optrace` records;

plus a dynamic check, :mod:`repro_torch.analysis.sanitize`, that replays
every ``commit()`` in a permuted message order and raises unless the
result is unchanged (``REPRO_SANITIZE=1`` / ``CommitSpec(sanitize=True)``).

``python -m repro_torch.analysis.lint`` runs the static passes and exits
nonzero on findings.
"""
