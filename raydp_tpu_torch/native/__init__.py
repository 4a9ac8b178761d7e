"""Native host kernels of the data plane (g++-built, ctypes-bound)."""
