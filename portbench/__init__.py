"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` drives ``repro_torch`` (``src/repro_torch``) through its
public entry points on the card and prints one JSON line.  Everything the
harness needs for one configuration, traffic mix, per-layer metric or run
driver sits in a file of its own, found by the name in ``BENCHMARK.json``:

- ``configs/<config>.json``: one configuration (sizes as run, source,
  ``reduced``, ``assumed``, the deployment it stands for);
- ``traffic/<mix>.json``: one traffic mix, read by ``traffic.py``;
- ``drivers/<driver>.py``: how a mix's requests reach the program (set-up,
  the timed window, the traced stretch, the check of outputs);
- ``metrics/<metric>.py``: one reader each, end-to-end or per-layer;
- ``work/``: operations and bytes of each op family from its shapes, and
  the chip's peaks;
- ``reference/``: the plain references that decide ``correct``.

Nothing here imports ``jax`` or the JAX package ``repro``; ``reference/``
imports nothing of ``repro_torch`` either.
"""
