"""Entry points.  Counterpart of ``repro/launch``: the training driver."""
