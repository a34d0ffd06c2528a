"""setup_s: from the process's start to the window's: imports, the CUDA
context, the kernel library's build or load, the render of the traffic,
the system's construction and the warm-up frames."""


def read(record):
  return record.setup_s
