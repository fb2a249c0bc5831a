"""One module a model family, named by the configuration's `family`: how a
run builds that family's system behind the served engine, sends it a
request, wraps its layers in ranges for the traced run, and compares what
it served with the plain reference."""

import dataclasses
import json


def plain(config) -> dict:
    """A config dataclass of the port as the configuration file writes it."""
    return json.loads(json.dumps(dataclasses.asdict(config)))


def constructor_args(section: dict) -> dict:
    """A section of the configuration file as a config dataclass takes it
    (lists as tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in section.items()}
