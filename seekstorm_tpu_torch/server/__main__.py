"""Server entry point (reference seekstorm_server/src/main.rs:149-170).

Usage:
    python -m seekstorm_tpu_torch.server [index_path=<dir>] [local_ip=<ip>]
    [local_port=<port>] [device=<cuda|cuda:N|cpu>] [--no-console]

``device`` (default ``cuda``) is the torch device every index and search of
the server runs on; ``cuda`` on a host without a card exits with an error
instead of serving from the CPU.
"""

from __future__ import annotations

import sys

from .app import SearchServer
from .console import run_console


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    opts = {"index_path": "seekstorm_index", "local_ip": "127.0.0.1",
            "local_port": "80", "device": "cuda"}
    console = True
    for a in argv:
        if a == "--no-console":
            console = False
        elif "=" in a:
            k, v = a.split("=", 1)
            opts[k] = v
    try:
        srv = SearchServer(opts["index_path"], opts["local_ip"],
                           int(opts["local_port"]), opts["device"])
    except (RuntimeError, ValueError) as e:
        print(f"seekstorm_tpu_torch.server: {e}", file=sys.stderr)
        sys.exit(2)
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    while srv.httpd is None:
        import time

        time.sleep(0.05)
    print(f"listening on http://{srv.host}:{srv.port}")
    print(f"device: {srv.device}")
    print(f"master apikey: {srv.master_key}", flush=True)
    if console:
        run_console(srv)
    else:
        try:
            t.join()
        except KeyboardInterrupt:
            srv.shutdown()


if __name__ == "__main__":
    main()
