"""Pairs trained in the window over its seconds (device-synchronised
edges; the CLI's read-backs and, under main_mlp, its evaluations
inside)."""


def read(record):
    w = record["window"]
    return w["pairs"] / w["seconds"]
