"""Native (C++) hot paths with pure-Python fallbacks: the chained block
hasher (``hashcore.cpp``) and the two-level LRU block index
(``lruindex.cpp``), byte-equal copies of the JAX package's sources, bound
with ctypes (``hashcore.py``, ``lruindex.py``) and compiled from this
package's own sources at first use (``build.py``)."""
