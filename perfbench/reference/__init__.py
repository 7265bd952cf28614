"""Plain float32 forwards of each model family, one module a family
(``<family>.py``), found by the ``family`` a configuration file names.
They import nothing of the program."""
