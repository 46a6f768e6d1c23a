"""The benchmark's plain reference: a serial host codec of the zling format
(``codec``), independent of the program under test."""
