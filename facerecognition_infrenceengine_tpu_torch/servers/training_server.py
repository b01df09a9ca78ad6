"""Enrollment worker entry point (the reference's ``trainingServer.py``), on
the card: the port's copy of
``facerecognition_infrenceengine_tpu/servers/training_server.py``.  The
worker builds ``FaceAnalysis`` on ``cuda`` at its first job.

Run: python -m facerecognition_infrenceengine_tpu_torch.servers.training_server
Multiple instances share the queue safely (claim-based work stealing,
reference trainingServer.py:491-513).
"""

from __future__ import annotations

import argparse
import signal

from ..core.config import get_config
from ..core.logging import setup_logging
from ..domain.enrollment import FaceEmbeddingWorker
from ..store.client import get_datastore
from ..store.indexes import init_db


def main(argv=None):
    parser = argparse.ArgumentParser(description="face enrollment worker (CUDA)")
    parser.add_argument("--worker-id", default=None)
    args = parser.parse_args(argv)

    logger = setup_logging("fre.training", logfile="face_embedding_worker.log")
    cfg = get_config()
    ds = get_datastore(cfg)
    init_db(ds)

    worker = FaceEmbeddingWorker(ds, cfg, worker_id=args.worker_id)

    def shutdown(signum, frame):
        logger.info("Shutdown signal received")
        worker.stop()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    worker.run()


if __name__ == "__main__":
    main()
