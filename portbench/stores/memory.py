"""The pool itself, in host memory: every block goes up through the
engine's pinned upload lanes."""


def open_frames(traffic, pool, workdir):
    return pool, (lambda: None)
