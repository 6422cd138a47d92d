"""One module a metric, named as in ``BENCHMARK.json``: each holds
``read(ctx) -> float | None`` (None: nothing to read in this run; the
metric is then left out of the result line). ``ctx`` is the run's
namespace ``benchmark.run.run`` builds: the cell's files, the work of a
request by layer as its driver counts it (``work``), the window's readings
(``window``), the set-up seconds and, in a traced run, the trace's summary
(``trace``: busy and window seconds, each ``benchmark/kernels/`` layer's
device seconds a request, and the traced window's ``device`` and ``host``
events). A roofline metric of a layer the drivers do not count passes its
own work to ``benchmark.trace.layer_share``."""
