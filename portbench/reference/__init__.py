"""The plain reference of the benchmark: plain PyTorch, no kernel, no part
of the port. ``plain/`` is a frozen copy of the port's plain modules
(``scene.py`` says which), ``scene.py`` the rays of a batch, ``oracle.py``
the fold and the comparison."""
