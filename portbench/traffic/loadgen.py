"""The open-loop load generator of ``http_open``, run as a process of its
own so that the server's interpreter lock cannot delay the schedule.

Reads a plan from standard input: ``{"url", "start", "grace",
"requests": [{"due", "path"}]}`` with ``start`` on the host's monotonic
clock and each ``due`` an offset from it.  Sends each request at its due
time from a thread of its own, whatever is still in flight, waits until
``grace`` seconds past the last due time at the most, and writes one JSON
list to standard output: per request its due, sent and done times, status
and base64 body (null for one that never completed).
"""

import base64
import json
import sys
import threading
import time
import urllib.error
import urllib.request


def fetch(url: str, due: float, out: list, i: int, timeout: float):
    sent = time.monotonic()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    except OSError:
        status, body = -1, b""
    out[i] = {"due": due, "sent": sent, "done": time.monotonic(),
              "status": status, "body": base64.b64encode(body).decode()}


def main():
    plan = json.load(sys.stdin)
    reqs, start = plan["requests"], plan["start"]
    out = [None] * len(reqs)
    threads = []
    for i, r in enumerate(reqs):
        due = start + r["due"]
        while True:
            wait = due - time.monotonic()
            if wait <= 0:
                break
            time.sleep(wait)
        th = threading.Thread(target=fetch, daemon=True, args=(
            plan["url"] + r["path"], due, out, i, plan["grace"]))
        th.start()
        threads.append(th)
    deadline = start + max(r["due"] for r in reqs) + plan["grace"]
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    main()
