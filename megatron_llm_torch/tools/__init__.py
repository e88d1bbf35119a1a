"""Command-line tools of the port (the twins of the repo's ``tools/``
that the port has): checkpoint conversion, the corpus builders, and the
router and fleet supervisor in front of the port's replicas
(``serve_router``, ``serve_fleet``)."""
