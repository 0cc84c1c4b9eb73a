"""Entry points.  Counterpart of ``repro/launch``: the training driver and
the rank world it runs over under torchrun."""
