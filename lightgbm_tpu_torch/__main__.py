"""``python -m lightgbm_tpu_torch``: the command line (``cli.py``).

``lint`` (the port's static analyzer, ``analysis/cli.py``), ``launch``
(the supervisor, ``resilience/elastic.py``), ``pipeline`` (the train ->
publish -> serve loop, ``pipeline.py``) and ``serve`` (the inference
daemon, ``serve/daemon.py``) are dispatched before the training CLI
loads. The package root is lazy, so none of them imports torch to parse
its arguments (``lint`` imports none at all but under ``--ir``): a
supervisor never holds the CUDA
context its workers need, and ``serve --help`` and a bad model path
exit at once. Torch loads in the pipeline's training workers (the
hidden ``--train-worker`` mode re-enters here) and in the replicas.
"""

import sys

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "lint":
        from .analysis.cli import main as lint_main
        sys.exit(lint_main(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "launch":
        from .resilience.elastic import main as launch_main
        sys.exit(launch_main(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "pipeline":
        from .pipeline import main as pipeline_main
        sys.exit(pipeline_main(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "serve":
        from .serve.daemon import main as serve_main
        sys.exit(serve_main(sys.argv[2:]))
    from .cli import main
    sys.exit(main())
