"""Command-line tools of the port (the twins of the repo's ``tools/``
that the port has): checkpoint conversion and the corpus builders."""
