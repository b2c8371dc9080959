"""streambench_tpu_torch — the PyTorch/CUDA port of ``streambench_tpu``.

The Yahoo Streaming Benchmark engine (filter "view" events, join ad ->
campaign, count per (campaign, 10 s tumbling window), write back to Redis)
with its device fold on torch tensors and its one hand-written kernel, the
masked cell count, in CUDA C++ for Hopper (``csrc/count_cells.cu``).

The JAX package stays the reference; this package imports nothing of it
and keeps its own copies of the JAX-free host modules it needs (config,
io, encode, native, datagen, metrics, trace).  Entry points run on
``cuda`` unless the caller asks for ``cpu``.  Importing the package
initialises no CUDA context and builds nothing: the native host library
and the CUDA kernel are compiled at first use into ``build/``.

Ported so far: the exact-count engine (``engine.AdAnalyticsEngine``,
``engine.StreamRunner``, ``python -m streambench_tpu_torch.engine``) with
its staged ingest pipeline, encode pool, Kafka source and dead-letter
queue, the generator CLI (``python -m streambench_tpu_torch.datagen``) and
the harness (``python -m streambench_tpu_torch.harness``); the sketch,
reach and sharded engines; the fork's count-window micro-batch mode
(``engine.microbatch``), the handoff benchmark (``handoff``) and the
dimensional family (``dimensions``).  ``ROADMAP.md`` lists what is left.
"""
