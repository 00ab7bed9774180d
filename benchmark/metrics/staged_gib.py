"""GiB the staged tables hold on the card: the program's
`QueryRunner.staged_bytes`."""


def read(run):
    return run["staged_bytes"] / 2**30
