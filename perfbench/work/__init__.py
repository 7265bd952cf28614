"""Operation and byte counts from shapes: a kernel's (``flash.py``,
``ssd.py``) and a model step's (``<family>.py``).  Frozen here so that the
yardstick does not move with the program."""
