"""Only the documented backend names are accepted: an unknown name is a
parse error, never a silent fall back to another backend."""

import numpy as np
import pytest

from kpop_tpu.utils.cli import ParseError


@pytest.mark.parametrize("name", ["device", "pallas", "gpu", "cuda"])
@pytest.mark.parametrize("tool", ["countdb", "twistdb", "twist"])
def test_cli_rejects_unknown_backend(tool, name):
    import importlib

    cli = importlib.import_module("kpop_tpu.cli." + tool)
    with pytest.raises(ParseError, match="Invalid backend"):
        cli.main(["--backend", name])


@pytest.mark.parametrize("name", ["device", "pallas"])
def test_twist_counter_db_rejects_unknown_backend(name):
    from kpop_tpu.core.counter_db import CounterDB
    from kpop_tpu.core.twister import twist_counter_db

    db = CounterDB(row_names=["00", "01", "02"], col_names=["a", "b"],
                   counts=np.array([[1, 2], [3, 1], [2, 2]], np.int32))
    with pytest.raises(ValueError, match="unknown CA backend"):
        twist_counter_db(db, backend=name)
