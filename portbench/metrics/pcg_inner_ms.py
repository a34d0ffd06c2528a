"""pcg_inner_ms: the program's span "BA PCG inner loop" (the conjugate-
gradient loop of ``models/pcg.pcg_solve``: a Hessian-vector product over
the participating keyframes, two dot products and one host read an
iteration) summed over the window, over its counter "BA PCG inner
iterations" summed, in ms an iteration, the profiled frames' left out; None
where either is missing or no iteration ran. Layer ``models.pcg``."""


def read(record):
  wall = record.timing.get("BA PCG inner loop")
  iterations = sum(record.timing.get("BA PCG inner iterations", []))
  if not wall or iterations <= 0:
    return None
  return 1e3 * sum(wall) / iterations
