"""Seconds of the device build: the host clock around `build_database`
(the `build+query` route, tables built on the card), ended by a
synchronise."""


def read(run):
    return run["build_s"]
