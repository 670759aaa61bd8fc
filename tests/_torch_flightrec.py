"""The port's flight recorder pointed at a pytest tmp dir.

The port's recorder dumps into ``$DL4J_TPU_FLIGHTREC_DIR`` or
``./flightrec_dumps`` (``telemetry/flightrec.py``), and
``tests/conftest.py`` points only the JAX package's recorder away from the
working tree. A port test file whose failure paths dump a black box takes
this fixture with one line::

    from _torch_flightrec import _port_flightrec_dir  # noqa: F401

It is autouse and module-scoped: each such file dumps into a tmp dir of
its own.
"""
import pytest

from deeplearning4j_tpu_torch.telemetry import configure_flight_recorder


@pytest.fixture(autouse=True, scope="module")
def _port_flightrec_dir(tmp_path_factory):
    configure_flight_recorder(
        directory=str(tmp_path_factory.mktemp("torch_flightrec")))
