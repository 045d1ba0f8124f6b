"""closed: one client, each request sent when the one before it has ended;
the window ends with the first request that ends at or after `seconds`."""

import time


def window(request, seconds: float, params: dict) -> list:
    """The window's requests; request(i) serves request i and returns it."""
    if params["clients"] != 1:
        raise SystemExit("the closed loop runs one client")
    requests = []
    t0 = time.perf_counter()
    while True:
        requests.append(request(len(requests)))
        if time.perf_counter() - t0 >= seconds:
            return requests
