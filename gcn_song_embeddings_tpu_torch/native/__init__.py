"""ctypes bindings to the repo's C++ readers (``native/*.cc``)."""
