"""The benchmark of ``repro_torch`` on NVIDIA H100s.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is found by name:

* ``configs/<config>.json`` -- the model's sizes as published, the port
  arch that runs it, ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json`` -- the parameters of a traffic mix, read by
  the one generator in :mod:`gpubench.generate`; its ``kind`` names the
  driver in ``drivers/<kind>.py`` that feeds it to the port;
* ``metrics/<metric>.py`` -- one reader per metric;
* ``limits/<cell>.json`` -- the limits of the numbers that decide
  ``correct``, each with the readings it was set from.

The yardstick is frozen here, not imported from the port: the work
counts (:mod:`gpubench.work`), the trace readers (:mod:`gpubench.trace`),
the weights (:mod:`gpubench.weights`) and the plain fp32 reference
(:mod:`gpubench.reference`), which imports nothing of the port.
"""
