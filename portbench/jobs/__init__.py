"""One module per traffic ``job``; each exposes ``run(cell) -> record``."""
