"""Process start to the window's start: imports, the CUDA context, the
kernels' load (and, on a checkout's first run, their build under
``build/repro_torch_kernels``), the inputs, the engine, the warm-up."""
KIND, UNIT, SOURCE, BETTER = "end_to_end", "s", "host_clock", "lower"


def read(r):
    return r.timing.setup_s if r.timing.setup_s > 0 else None
