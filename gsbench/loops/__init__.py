"""Window loops, one module per kind of traffic mix; a mix's file names
its loop (``"loop"``).  Each module has ``setup(run)``,
``window(run)``, ``traced(run)``, ``release(run)``, ``check(run)`` and
``work(run)``."""
