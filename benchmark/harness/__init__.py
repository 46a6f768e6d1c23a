"""The benchmark's general code: the manifest and the files it names
(``layout``), the corpus generator (``corpus``), the run (``runner``),
the reading of a profiler trace (``reading``) and the g++ builds of the
benchmark's own C++ (``gxx``)."""
