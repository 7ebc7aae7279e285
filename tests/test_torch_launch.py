"""The port's operator launcher (``python -m repro_torch.launch.deid_service``)
against the JAX package's, with the same arguments, plain and ``--chaos``.

The returned dict must be equal field for field, and so must the two printed
lines, except what names a stored size: ``bytes`` is the at-rest size of the
synthetic archive (``StudyStore`` pickles, which name their package's
module) and ``throughput`` is that size over the drain's sim time. Each is
compared through what it names: the same studies put into a store of the
launcher's own package, with the launcher's key, give its ``bytes``.
"""
import contextlib
import io

import pytest
import torch

from repro.dicom.generator import StudyGenerator as JaxGenerator
from repro.launch.deid_service import main as jax_main
from repro.storage.object_store import StudyStore as JaxStore

from repro_torch.carry import study_from_plain, study_to_plain
from repro_torch.dicom.generator import StudyGenerator
from repro_torch.launch.deid_service import main
from repro_torch.storage.object_store import StudyStore
from repro_torch.utils.bytesize import human_bytes

STUDIES, IMAGES, SEED = 4, 1, 0
EQUAL_FIELDS = ("studies", "instances", "minutes", "cost_usd", "crashes", "health")


def _args(tmp_path, name, *extra):
    return ["--studies", str(STUDIES), "--images-per-study", str(IMAGES),
            "--journal", str(tmp_path / f"{name}.jsonl"), "--seed", str(SEED), *extra]


def _archive_bytes(store_cls, studies):
    """At-rest bytes of ``studies`` in a store of ``store_cls``'s package,
    keyed as the launcher keys its archive."""
    store = store_cls("lake", key=b"at-rest-key")
    for s in studies:
        store.put_study(s.accession, s)
    return store.store.total_bytes()


def _launcher_studies(gen):
    return [gen.gen_study(f"SRV{i:05d}", n_images=IMAGES) for i in range(STUDIES)]


def _run(launcher, argv):
    """The launcher's returned dict and its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = launcher(argv)
    return result, out.getvalue().splitlines()


@pytest.fixture(scope="module", params=[(), ("--chaos",)], ids=["plain", "chaos"])
def launched(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    extra = request.param
    got, port_lines = _run(main, _args(tmp, "torch", "--device", "cpu", *extra))
    want, jax_lines = _run(jax_main, _args(tmp, "jax", *extra))
    return extra, got, port_lines, want, jax_lines


def test_returned_dict_equal(launched):
    extra, got, _, want, _ = launched
    assert set(got) == set(want)
    for f in EQUAL_FIELDS:
        assert got[f] == want[f], f
    assert got["studies"] == STUDIES
    assert got["instances"]["anonymized"] == STUDIES * IMAGES
    if extra:
        assert got["crashes"] > 0
    assert got["health"]["states"] == {"cold_serve": "ok"}


@pytest.fixture(scope="module")
def archives():
    """At-rest bytes of the launcher's archive: the JAX studies in a JAX
    store, the same studies carried across in a port store, and the port
    generator's studies in a port store."""
    jax_studies = _launcher_studies(JaxGenerator(SEED))
    carried = [study_from_plain(study_to_plain(s)) for s in jax_studies]
    return (_archive_bytes(JaxStore, jax_studies), _archive_bytes(StudyStore, carried),
            _archive_bytes(StudyStore, _launcher_studies(StudyGenerator(SEED))))


def test_bytes_and_throughput_name_the_same_archive(launched, archives):
    _, got, _, want, _ = launched
    jax_bytes, carried_bytes, port_bytes = archives
    assert got["bytes"] == carried_bytes == port_bytes
    assert want["bytes"] == jax_bytes
    for out in (got, want):
        assert out["throughput"] == out["bytes"] / (out["minutes"] * 60)


def test_printed_report_equal(launched):
    _, got, port_lines, _, jax_lines = launched
    assert len(port_lines) == len(jax_lines) == 2
    assert port_lines[1] == jax_lines[1] and port_lines[1].startswith("health: ")
    p, j = port_lines[0].split(" | "), jax_lines[0].split(" | ")
    assert [p[i] for i in (0, 2, 4, 5)] == [j[i] for i in (0, 2, 4, 5)]
    assert p[1] == human_bytes(got["bytes"])
    assert p[3] == f"{human_bytes(got['throughput'])}/s"


def test_default_device_is_the_card(tmp_path):
    args = ["--studies", "1", "--images-per-study", "1", "--journal", str(tmp_path / "j.jsonl")]
    if torch.cuda.is_available():
        assert main(args)["studies"] == 1
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)
