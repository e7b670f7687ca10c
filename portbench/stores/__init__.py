"""Where a cell's frames come from, one module a store, found by the
``store`` key of a traffic file.  Each module's ``open_frames(traffic, pool,
workdir)`` returns ``(reader, close)``: a reader of the pool's frames
(anything with ``len`` and slices of frames) and what closes it; a store
that writes a file writes it under ``workdir``."""
