"""The port's native host engine: C++ compiled on demand, bound via ctypes."""
