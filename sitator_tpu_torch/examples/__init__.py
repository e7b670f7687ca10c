"""The walkthroughs of ``examples/`` on the port: each runs its engines on
``--device`` (default ``cuda``) and prints the reference's lines.  Run one
as ``python3 -m sitator_tpu_torch.examples.<name> [--device {cuda,cpu}]``
or ``python3 sitator_tpu_torch/examples/<name>.py``; each has
``main(argv) -> int``."""
