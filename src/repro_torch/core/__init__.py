"""WAGMA-SGD core, replicated realisation on one device: the group schedule
(``grouping``), flat buckets (``bucketing``), the wavefront (``overlap``),
the compiled averaging plan (``plan``) and the averager (``wagma``).

Counterpart of ``repro/core``.  Every replicated tree is stacked: each leaf
has the JAX global layout ``(P, ...)``, one row per replica.
"""
