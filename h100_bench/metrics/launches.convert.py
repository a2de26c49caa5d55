"""The runtime's launch, copy and fill calls (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel*``, ``cudaMemcpyAsync``,
``cudaMemsetAsync``) on the calling thread inside the traced convert
calls, divided by the calls."""

from h100_bench.harness.spans import launches


def read(run):
    return launches(run, "convert")
