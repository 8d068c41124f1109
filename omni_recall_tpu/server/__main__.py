"""Run the Omni Recall TPU server: ``python -m omni_recall_tpu.server``."""

from __future__ import annotations

import argparse
import logging
from wsgiref.simple_server import WSGIServer, make_server
from socketserver import ThreadingMixIn

from omni_recall_tpu.config import load_config
from omni_recall_tpu.server.app import build_app
from omni_recall_tpu.utils.compile_cache import enable_compile_cache


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


def main() -> None:
    parser = argparse.ArgumentParser(description="Omni Recall TPU server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--settings", default=None, help="appsettings.json path")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    enable_compile_cache()
    config = load_config(settings_file=args.settings)
    app = build_app(config)
    with make_server(args.host, args.port, app, server_class=ThreadingWSGIServer) as server:
        logging.getLogger(__name__).info(
            "Omni Recall TPU listening on http://%s:%d (engine backend=%s)",
            args.host, args.port, config.engine.backend,
        )
        server.serve_forever()


if __name__ == "__main__":
    main()
