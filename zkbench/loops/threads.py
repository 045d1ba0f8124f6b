"""threads: `clients` closed-loop clients, each a thread of this process.

Each thread takes the next request index from a counter shared under a lock
and serves it, then the next, and stops after its first request that ends
at or after `seconds`; no index is taken and left unserved, so the indices
served are 0 ... n - 1.  A thread carries its client number as the
attribute `client` (0 ... clients - 1), which the worker steps read
(steps/worker_claim.py).  The window ends when every thread has joined; its
records come back ordered by index.  An exception in a thread ends the
window: the other threads stop taking requests, and it is raised here.
"""

import threading
import time


def window(request, seconds: float, params: dict) -> list:
    """The window's requests; request(i) serves request i and returns it."""
    lock = threading.Lock()
    records, errors, taken = [], [], [0]
    t0 = time.perf_counter()

    def client():
        while True:
            with lock:
                if errors:
                    return
                i = taken[0]
                taken[0] += 1
            try:
                rec = request(i)
            except BaseException as exc:               # raised again after the join
                with lock:
                    errors.append(exc)
                return
            with lock:
                records.append(rec)
            if time.perf_counter() - t0 >= seconds:
                return

    threads = []
    for k in range(params["clients"]):
        t = threading.Thread(target=client, name=f"zkbench-client-{k}")
        t.client = k
        threads.append(t)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return sorted(records, key=lambda r: r["index"])
