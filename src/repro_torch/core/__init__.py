"""WAGMA-SGD core, replicated realisation: the group schedule
(``grouping``), flat buckets (``bucketing``), the wavefront (``overlap``),
the compiled averaging plan and its wire (``plan``) and the averagers
(``wagma``, ``baselines``).

Counterpart of ``repro/core``.  A replicated tree is stacked, each leaf
in the JAX global layout ``(P, ...)`` with one row per replica, or, over a
rank world, this rank's ``(1, ...)`` row.
"""
