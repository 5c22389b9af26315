"""The host's time per step inside CUDA runtime calls that wait for the
card, in the host-traced stretch: ``cudaStreamSynchronize``,
``cudaEventSynchronize``, ``cudaDeviceSynchronize``, ``cudaMemcpy`` (not
``cudaMemcpyAsync``), ``cudaFree``, ``cudaFreeHost`` and
``cudaHostAlloc``/``cudaMallocHost`` (``portbench.phases.BLOCKING``).
Only calls inside a step count: the synchronize that closes the stretch
has no range open but the harness's window."""


def read(ctx):
    spans = ctx.get("spans")
    if not spans or not spans["steps"]:
        return None
    inside = [c["dur"] for c in spans["blocking"] if c["range"] not in (None, "window")]
    return 1e3 * sum(inside) / spans["steps"]
