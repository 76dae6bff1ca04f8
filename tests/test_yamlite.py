"""The in-repo YAML reader (io/yamlite.py) against PyYAML, and the main
path's independence from PyYAML."""

import pathlib
import subprocess
import sys

import pytest
import yaml

from linearham_tpu.io import yamlite

FIXTURE_YAML = sorted(
    str(p.relative_to(pathlib.Path(__file__).parent / "fixtures"))
    for p in (pathlib.Path(__file__).parent / "fixtures").rglob("*.yaml"))


@pytest.mark.parametrize("name", FIXTURE_YAML)
def test_reader_matches_pyyaml_on_fixture(fixtures_dir, name):
    path = fixtures_dir / name
    assert yamlite.load_file(str(path)) == yaml.safe_load(path.read_text())


def test_reader_matches_pyyaml_on_written_gene_files(tmp_path):
    """The gene files write_gene_dir emits (synthetic families, bench
    inputs) read back identically."""
    from linearham_tpu.io.germline import write_gene_dir
    from linearham_tpu.utils.synth import make_family, make_light_family

    for fam, sub in ((make_family(n_seqs=3, seed=1), "igh"),
                     (make_light_family(n_seqs=3, seed=2), "igk")):
        write_gene_dir(fam.genes, str(tmp_path / sub))
    files = sorted(tmp_path.rglob("*.yaml"))
    assert len(files) >= 10
    for p in files:
        assert yamlite.load_file(str(p)) == yaml.safe_load(p.read_text()), p


def test_reader_scalars_and_nesting():
    text = ("# comment\n"
            "a: 'it''s'   # trailing comment\n"
            "b: \"x\\ty\"\n"
            "c: [1, -2.5, ~, yes, N, 1e-05, .inf]\n"
            "d:\n"
            "- {e: f, g: [1, 2]}\n"
            "-\n"
            "  h: null\n"
            "  i: {}\n"
            "j:\n"
            "  k: 0.1\n")
    assert yamlite.load(text) == yaml.safe_load(text)


def test_reader_reads_safe_dump_output():
    """What yaml.safe_dump writes for partis-like data — nested block
    sequences, anchors and aliases for shared objects — reads back."""
    ids = ["seq0", "seq1"]
    doc = {"events": [{"unique_ids": ids, "duplicates": [[], ["x"]],
                       "naive_seq": "ACGT", "has_shm_indels": [False, True],
                       "mapping": {"a": 1.5, "b": None}}],
           "partitions": [{"partition": [ids], "logprob": -1.0}]}
    text = yaml.safe_dump(doc, sort_keys=False, width=10 ** 6)
    assert "&id" in text and "- - " in text      # the constructs occur
    assert yamlite.load(text) == doc


def test_reader_rejects_unsupported_constructs():
    with pytest.raises(ValueError):
        yamlite.load("a: !!python/tuple [1, 2]\n")
    with pytest.raises(ValueError):
        yamlite.load("a: |\n  text\n")
    with pytest.raises(ValueError):
        yamlite.load("a: *undefined\n")


def test_main_path_imports_without_pyyaml(fixtures_dir):
    """The CLI, the pipeline and the input readers never import PyYAML."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import linearham_tpu.cli, linearham_tpu.pipeline.run\n"
        "from linearham_tpu.io.partis import load_cluster\n"
        "from linearham_tpu.io.germline import load_gene_map\n"
        f"c = load_cluster({str(fixtures_dir / 'phylo_hmm_input.yaml')!r}, 0)\n"
        f"g = load_gene_map({str(fixtures_dir / 'hmm_params')!r})\n"
        "assert c.locus == 'igh' and g\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
