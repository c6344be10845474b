"""The benchmark's harness: the generator, the driver of the engine, the
check against the reference, the reading of traces and the result line.
``program.py`` is the only module that imports the program under test."""
