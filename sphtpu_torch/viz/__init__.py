from .render import render_snapshot_figures, render_from_files, watch  # noqa: F401
