"""Launch counts of the kernel wrappers, exact across threads.

Each wrapper in ``ops.COUNTED`` adds one to its ``launches`` where it
launches its kernel, under ``LAUNCH_LOCK``. A caller that must read the
launches of its own thread alone off these process-wide counts (a decode
graph's capture, ``server/decode_graphs.py``) holds the lock over the span
it measures; another thread's launch then waits to be counted until the
span ends. Re-entrant: the holder's own wrappers still count.
"""

import threading

LAUNCH_LOCK = threading.RLock()


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel."""
    with LAUNCH_LOCK:
        wrapper.launches += 1
