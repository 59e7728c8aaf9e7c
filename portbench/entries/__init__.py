"""The program's entry points the cells drive, one module per entry a
workload names. Each has ``build(prob, settings, device)`` returning an
object with ``solve(max_iter, stop_tol) -> dict`` (unscaled X, y, S, the
info rows, the iterations run and a failure or None), ``facts()``,
``captures()`` and ``init_breakdown``. These are the only modules of the
benchmark that import cuadmm_tpu_torch."""
