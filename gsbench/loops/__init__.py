"""Window loops, one module per kind of traffic mix; a mix's file names
its loop (``"loop"``) and may name the kind of loop it is (``"kind"``:
``"train"`` or ``"serve"``, the module's name where it names none),
whose metrics it then reports.  Each module has ``setup(run)``,
``window(run)``, ``traced(run)``, ``release(run)``, ``check(run)`` and
``work(run)``."""
