"""``python -m lightgbm_tpu_torch``: the command line (``cli.py``).

``serve`` (the inference daemon, ``serve/daemon.py``) is dispatched
before the training CLI loads: the package root is lazy, so ``serve
--help`` and a bad model path exit without importing torch.
"""

import sys

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "serve":
        from .serve.daemon import main as serve_main
        sys.exit(serve_main(sys.argv[2:]))
    from .cli import main
    sys.exit(main())
