"""Native C++ host cores (ctypes, self-building with g++)."""
