"""One module a program path a traffic mix can name (its ``path`` key):
``Driver(run)`` builds the port's system and warms it, ``job(k)`` runs the
window's ``k``-th job through it, ``compare()`` reads the comparison."""
