"""CLI tests: flag surface, driver orchestration, output naming, parity.

Covers the reference's two CLI layers (reference: epik.py:29-70 and
epik/src/epik/main.cpp:205-265) plus the end-to-end differential gate.
"""

import json

import numpy as np
import pytest
from epik_tpu.cli.main import main, make_invocation, make_output_filename
from epik_tpu.core.alphabet import DNA
from epik_tpu.io.build import random_db
from epik_tpu.io.db import save
from epik_tpu.tools.jplace_diff import jplace_diff
from epik_tpu.utils.progress import humanize_time, parse_human_readable, to_human_readable


class _Result:
    def __init__(self, exit_code: int, output: str):
        self.exit_code = exit_code
        self.output = output


@pytest.fixture
def cli(capsys):
    """Run ``epik`` in-process through ``main(argv)``; the result carries
    the exit code and stdout + stderr (as a terminal would show them)."""

    def run(args):
        capsys.readouterr()  # drop anything printed before this call
        try:
            code = main([str(a) for a in args])
        except SystemExit as e:  # argparse: --help, usage errors
            code = e.code if isinstance(e.code, int) else 1
        out, err = capsys.readouterr()
        return _Result(code, out + err)

    return run


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=77)
    save(db, d / "DB.eptk")
    rng = np.random.default_rng(5)
    with open(d / "q.fasta", "w") as f:
        for i in range(30):
            parts = [
                DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                for _ in range(5)
            ]
            f.write(f">q{i}\n{''.join(parts)}\n")
    return d


class TestHelpers:
    def test_invocation_trailing_space(self):
        # reference: main.cpp:23-32 joins argv with a trailing space
        assert make_invocation(["epik", "place", "-i", "db"]) == "epik place -i db "

    def test_output_filename(self):
        # reference: main.cpp:34-37 -- keeps the input extension
        assert make_output_filename("/x/y/reads.fasta", "/out") == "/out/placements_reads.fasta.jplace"

    @pytest.mark.parametrize(
        "s,expect",
        [("100", 100), ("128K", 131072), ("50M", 52428800), ("1G", 1073741824),
         ("4.5K", 4608), ("2b", 2)],
    )
    def test_parse_max_ram(self, s, expect):
        assert parse_human_readable(s) == expect

    def test_parse_max_ram_bad(self):
        with pytest.raises(ValueError):
            parse_human_readable("12X")
        with pytest.raises(ValueError):
            parse_human_readable("abc")

    def test_to_human_readable(self):
        assert to_human_readable(100) == "100"
        assert to_human_readable(2048) == "2K"
        assert to_human_readable(1536) == "1.5K"
        assert to_human_readable(3 * 1024 * 1024) == "3M"

    def test_humanize_time(self):
        assert humanize_time(65_000) == "01:05"
        assert humanize_time(3_725_000) == "01:02:05"
        assert humanize_time(90_000_000) == "1 day, 01:00:00"


class TestPlaceCommand:
    @pytest.fixture(autouse=True)
    def _cli(self, cli):
        self.cli = cli

    def _run(self, fixture_dir, outsub, *extra):
        out = fixture_dir / outsub
        out.mkdir(exist_ok=True)
        result = self.cli(
            ["place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out),
             str(fixture_dir / "q.fasta"), *extra],
        )
        return result, out / "placements_q.fasta.jplace"

    def test_place_jax(self, fixture_dir):
        result, jp = self._run(fixture_dir, "oj", "--engine", "jax")
        assert result.exit_code == 0, result.output
        assert "Placed 30 sequences." in result.output
        assert "Database parameters:" in result.output
        assert "Loaded " in result.output
        content = json.loads(jp.read_text())
        assert content["version"] == 3
        assert len(content["placements"]) >= 1

    def test_engine_parity(self, fixture_dir):
        _, jp1 = self._run(fixture_dir, "oj2", "--engine", "jax")
        _, jp2 = self._run(fixture_dir, "orf", "--engine", "reference")
        res = jplace_diff(str(jp1), str(jp2))
        assert res.clean, res.mismatches[:5]

    def test_states_mismatch(self, fixture_dir):
        result, _ = self._run(fixture_dir, "os", "-s", "amino")
        assert result.exit_code != 0

    def test_bad_mu(self, fixture_dir):
        result, _ = self._run(fixture_dir, "om", "--mu", "2.0")
        assert result.exit_code != 0
        assert "Mu has to a value in [0, 1]" in result.output

    def test_max_ram(self, fixture_dir):
        result, jp = self._run(fixture_dir, "omr", "--max-ram", "2K")
        assert result.exit_code == 0
        assert "Max-RAM provided" in result.output
        # 2K / 8 bytes = 256 entries max
        assert "256" in result.output

    def test_batch_size(self, fixture_dir):
        result, jp = self._run(fixture_dir, "ob", "--batch-size", "7")
        assert result.exit_code == 0
        content = json.loads(jp.read_text())
        names = [nm[0] for p in content["placements"] for nm in p["nm"]]
        assert len(names) == 30

    def test_help(self):
        result = self.cli(["place", "--help"])
        assert result.exit_code == 0
        for flag in ("--database", "--states", "--omega", "--mu", "--max-ram",
                     "--keep-at-most", "--keep-factor", "--batch-size"):
            assert flag in result.output


class TestSubcommands:
    def test_convert_roundtrip(self, cli, fixture_dir, tmp_path):
        ipk = tmp_path / "db.ipk"
        back = tmp_path / "back.eptk"
        r1 = cli(["convert", str(fixture_dir / "DB.eptk"), str(ipk)])
        assert r1.exit_code == 0, r1.output
        r2 = cli(["convert", str(ipk), str(back)])
        assert r2.exit_code == 0, r2.output
        from epik_tpu.io.db import load

        a, b = load(fixture_dir / "DB.eptk"), load(back)
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.scores, b.scores)

    def test_diff_command(self, cli, fixture_dir):
        out = fixture_dir / "od1"
        out.mkdir(exist_ok=True)
        r = cli(["place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out),
                 str(fixture_dir / "q.fasta")])
        assert r.exit_code == 0
        jp = str(out / "placements_q.fasta.jplace")
        r = cli(["diff", jp, jp])
        assert r.exit_code == 0
        assert "30/30 placements match." in r.output

    def test_ppdiff_command_help(self, cli):
        r = cli(["ppdiff", "--help"])
        assert r.exit_code == 0


class TestResume:
    def test_resume_continues_from_batch_checkpoint(self, cli, fixture_dir, tmp_path):
        out = tmp_path / "res"
        out.mkdir()
        args = ["place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out),
                "--batch-size", "10", str(fixture_dir / "q.fasta")]
        r = cli(args)
        assert r.exit_code == 0
        jp = out / "placements_q.fasta.jplace"
        full = jp.read_text()
        import json as _json

        expect_names = sorted(
            nm[0] for p in _json.loads(full)["placements"] for nm in p["nm"]
        )

        # simulate a crash after the FIRST batch: replay one batch manually so
        # the .resume sidecar exists (end() removes it on clean completion)
        from epik_tpu.core.tree import parse_newick, to_newick
        from epik_tpu.engine.reference import ReferencePlacer
        from epik_tpu.io.db import load as load_db
        from epik_tpu.io.fasta import read_fasta
        from epik_tpu.io.jplace import jplace_writer

        db = load_db(fixture_dir / "DB.eptk")
        tree = parse_newick(db.tree())
        records = read_fasta(fixture_dir / "q.fasta")
        w = jplace_writer(str(jp), "inv ", to_newick(tree, jplace_edges=True))
        w.start()
        w << ReferencePlacer(db, tree).place(records[:10])
        # crash: no end(); header + one batch + sidecar on disk
        w._out.flush()

        r2 = cli(args + ["--resume"])
        assert r2.exit_code == 0, r2.output
        assert "Resuming: 10 reads already placed." in r2.output
        content2 = _json.loads(jp.read_text())
        names = sorted(nm[0] for p in content2["placements"] for nm in p["nm"])
        assert names == expect_names
        assert not (out / "placements_q.fasta.jplace.resume").exists()

    def test_resume_mid_batch_duplicates_are_not_lost(self, cli, tmp_path):
        """A crash between batches must not drop records even when batches
        contain interleaved duplicate sequences (dedup reorders objects)."""
        import json as _json

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=70)
        save(db, tmp_path / "DB.eptk")
        from epik_tpu.core.alphabet import DNA

        seq_a = "".join(DNA.decode_key(int(db.keys[j]), 6) for j in (1, 2, 3))
        seq_b = "".join(DNA.decode_key(int(db.keys[j]), 6) for j in (4, 5, 6))
        # batch of 3: r1=A, r2=B, r3=A (duplicates interleaved)
        with open(tmp_path / "q.fasta", "w") as f:
            for name, seq in [("r1", seq_a), ("r2", seq_b), ("r3", seq_a),
                              ("r4", seq_b), ("r5", seq_a), ("r6", seq_b)]:
                f.write(f">{name}\n{seq}\n")
        out = tmp_path / "o"
        out.mkdir()
        args = ["place", "-i", str(tmp_path / "DB.eptk"), "-o", str(out),
                "--batch-size", "3", str(tmp_path / "q.fasta")]
        # write only the first batch (r1..r3), then "crash"
        from epik_tpu.core.tree import parse_newick, to_newick
        from epik_tpu.engine.reference import ReferencePlacer
        from epik_tpu.io.db import load as load_db
        from epik_tpu.io.jplace import jplace_writer

        db2 = load_db(tmp_path / "DB.eptk")
        tree = parse_newick(db2.tree())
        jp = out / "placements_q.fasta.jplace"
        w = jplace_writer(str(jp), "inv ", to_newick(tree, jplace_edges=True))
        w.start()
        recs = [("r1", seq_a.encode()), ("r2", seq_b.encode()), ("r3", seq_a.encode())]
        w << ReferencePlacer(db2, tree).place(recs)
        w._out.flush()

        r = cli(args + ["--resume"])
        assert r.exit_code == 0, r.output
        assert "Resuming: 3 reads already placed." in r.output
        content = _json.loads(jp.read_text())
        names = sorted(nm[0] for p in content["placements"] for nm in p["nm"])
        assert names == ["r1", "r2", "r3", "r4", "r5", "r6"]

    def test_resume_without_sidecar_is_fresh_start(self, cli, fixture_dir, tmp_path):
        out = tmp_path / "rf"
        out.mkdir()
        jp = out / "placements_q.fasta.jplace"
        jp.write_text("{ garbage, no sidecar")
        r = cli([
            "place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out),
            "--resume", str(fixture_dir / "q.fasta"),
        ])
        assert r.exit_code == 0, r.output
        assert "Resuming:" not in r.output  # fresh start
        import json as _json

        content = _json.loads(jp.read_text())  # valid, with header
        assert content["version"] == 3

    def test_scan_partial(self, tmp_path):
        from epik_tpu.io.jplace import scan_partial

        f = tmp_path / "p.jplace"
        f.write_text('{\n    "placements": [\n        {\n            "p": [\n'
                     '                [1, -0.5, 0.3, 0.1, 0.2]\n            ],\n'
                     '            "nm": [\n                ["a", 1],\n'
                     '                ["b", 1]\n            ]\n        },\n'
                     '        {\n            "p": [')
        n, trunc = scan_partial(str(f))
        assert n == 2
        text = f.read_text()
        assert text[:trunc].rstrip().endswith("}")


class TestShardedEngine:
    def test_place_sharded(self, cli, fixture_dir):
        out = fixture_dir / "osh"
        out.mkdir(exist_ok=True)
        r = cli(["place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out),
                 "--engine", "sharded", "--n-model", "2",
                 str(fixture_dir / "q.fasta")])
        assert r.exit_code == 0, r.output
        assert "sharded mesh 4x2" in r.output
        jp1 = out / "placements_q.fasta.jplace"
        # parity vs the single-device engine output
        out2 = fixture_dir / "osh1"
        out2.mkdir(exist_ok=True)
        cli(["place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out2),
             str(fixture_dir / "q.fasta")])
        res = jplace_diff(str(jp1), str(out2 / "placements_q.fasta.jplace"))
        assert res.clean, res.mismatches[:3]


class TestUtilityCommands:
    def test_stats(self, cli, fixture_dir):
        r = cli(["stats", str(fixture_dir / "DB.eptk")])
        assert r.exit_code == 0, r.output
        assert "Sequence type: nucl" in r.output
        assert "k-mers: 1024" in r.output

    def test_build_db(self, cli, tmp_path):
        import json as _json

        (tmp_path / "tree.nwk").write_text("((A:0.1,B:0.2):0.3,C:0.4):0.0;")
        (tmp_path / "entries.json").write_text(
            _json.dumps({"ACG": [[0, -1.0], [2, -2.0]], "CGT": [[1, -0.5]]})
        )
        out = tmp_path / "out.eptk"
        r = cli([
            "build-db", "--tree", str(tmp_path / "tree.nwk"),
            "--entries", str(tmp_path / "entries.json"), "-k", "3", str(out),
        ])
        assert r.exit_code == 0, r.output
        from epik_tpu.io.db import load

        db = load(out)
        assert db.num_kmers == 2 and db.num_entries == 3


class TestAminoEndToEnd:
    def test_place_amino(self, cli, tmp_path):
        from epik_tpu.core.alphabet import AMINO

        db = random_db(num_leaves=12, kmer_size=4, num_kmers=800, seed=91,
                       sequence_type="amino")
        save(db, tmp_path / "aa.eptk")
        rng = np.random.default_rng(92)
        with open(tmp_path / "q.fasta", "w") as f:
            for i in range(15):
                parts = [
                    AMINO.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 4)
                    for _ in range(4)
                ]
                f.write(f">p{i}\n{''.join(parts)}\n")
        out = tmp_path / "out"
        out.mkdir()
        r = cli([
            "place", "-i", str(tmp_path / "aa.eptk"), "-s", "amino",
            "-o", str(out), str(tmp_path / "q.fasta"),
        ])
        assert r.exit_code == 0, r.output
        assert "Sequence type: amino" in r.output
        content = json.loads((out / "placements_q.fasta.jplace").read_text())
        assert len(content["placements"]) >= 1
        # parity with the oracle
        r2 = cli([
            "place", "-i", str(tmp_path / "aa.eptk"), "-s", "amino",
            "-o", str(out), "--engine", "reference", str(tmp_path / "q.fasta"),
        ])
        # same file name: second run overwrote; rerun to diff properly
        out2 = tmp_path / "out2"
        out2.mkdir()
        cli([
            "place", "-i", str(tmp_path / "aa.eptk"), "-s", "amino",
            "-o", str(out2), str(tmp_path / "q.fasta"),
        ])
        res = jplace_diff(str(out / "placements_q.fasta.jplace"),
                          str(out2 / "placements_q.fasta.jplace"))
        assert res.clean


class TestGzipInput:
    def test_place_gzip_fasta(self, cli, fixture_dir, tmp_path):
        import gzip

        gz = tmp_path / "q.fasta.gz"
        gz.write_bytes(gzip.compress((fixture_dir / "q.fasta").read_bytes()))
        out = tmp_path / "og"
        out.mkdir()
        r = cli([
            "place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out), str(gz),
        ])
        assert r.exit_code == 0, r.output
        content = json.loads((out / "placements_q.fasta.gz.jplace").read_text())
        assert sum(len(p["nm"]) for p in content["placements"]) == 30
