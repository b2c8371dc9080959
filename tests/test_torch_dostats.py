"""The port's golden model, ``datagen.gen.dostats``, against the JAX
package's on the same journals; and the generator's seeded ids and
ad -> campaign file, written and read, against the JAX package's.

The port scans a chunk of lines as one text, one value a line, and
parses line by line with ``json`` where a value does not end at its own
line's end: both ways must give the reference's counts, and a torn
journal must raise in both oracles, on generator journals (the
Python and the native formatter, skew on) and on lines in other forms
(other spacing, escapes, blank lines, ``str`` lines, a line without its
newline, ads the map does not know, a newline inside an element).
"""

import json
import os
import random

import pytest

from streambench_tpu.datagen import gen as jax_gen
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.utils.ids import make_ids
from tests.test_torch_engine import write_journal


def _mapping(wd):
    return gen.load_ad_mapping_file(os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))


def _both(wd, events=None, **kw):
    mapping = _mapping(wd)
    got = gen.dostats(wd, events=None if events is None else list(events),
                      mapping=mapping, **kw)
    want = jax_gen.dostats(wd, events=None if events is None
                           else list(events), mapping=mapping, **kw)
    return got, want


@pytest.mark.parametrize("spacing,divisor", [(10, 10_000), (1, 1_000)])
def test_generator_journal_equals_jax(tmp_path, spacing, divisor):
    wd = str(tmp_path)
    write_journal(wd, 20_000, spacing, seed=5 + spacing)
    got, want = _both(wd, time_divisor_ms=divisor)
    assert got == want and sum(sum(v.values()) for v in got.values()) > 0


def test_native_formatter_journal_equals_jax(tmp_path):
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.io.journal import FileBroker

    wd = str(tmp_path)
    gen.do_setup(None, default_config(), events_num=30_000,
                 broker=FileBroker(os.path.join(wd, "broker")),
                 rng=random.Random(7), workdir=wd)
    got, want = _both(wd)
    assert got == want and got


def _odd_lines(wd):
    rng = random.Random(3)
    mapping = _mapping(wd)
    ads = sorted(mapping)
    src = gen.EventSource(ads=ads + make_ids(3, rng),
                          user_ids=make_ids(20, rng),
                          page_ids=make_ids(5, rng), rng=rng)
    lines = [src.event_at(1_700_000_000_000 + 7 * i).encode() + b"\n"
             for i in range(3_000)]
    view = json.loads(lines[0])
    view.update(event_type="view", ad_id=ads[0])
    odd = [
        json.dumps(view, separators=(",", ":")).encode(),     # spacing
        json.dumps(dict(view, user_id='a"b')).encode(),       # an escape
        b"   \n", b"\n", b"",                                   # blanks
        json.dumps(view) + "\n",                               # str
        (json.dumps(view) + "\r\n").encode(),
        json.dumps(dict(view, event_time="-12345")).encode(),
    ]
    return lines, odd


@pytest.mark.parametrize("where", ["start", "middle", "end", "none"])
def test_lines_in_other_forms_equal_jax(tmp_path, where):
    wd = str(tmp_path)
    write_journal(wd, 10, 10, seed=1)
    lines, odd = _odd_lines(wd)
    at = {"start": 0, "middle": len(lines) // 2, "end": len(lines),
          "none": None}[where]
    events = lines if at is None else lines[:at] + odd + lines[at:]
    got, want = _both(wd, events=events)
    assert got == want and got


def test_the_json_path_gives_the_pattern_paths_counts(tmp_path,
                                                      monkeypatch):
    wd = str(tmp_path)
    write_journal(wd, 20_000, 10, seed=11)
    fast = gen.dostats(wd)
    path = os.path.join(wd, gen.KAFKA_JSON_FILE)

    def as_lines():
        with open(path, "rb") as f:
            return gen.dostats(wd, events=list(f))

    monkeypatch.setattr(gen, "_STATS_CHUNK", 777)
    monkeypatch.setattr(gen, "_STATS_BLOCK", 777)
    assert gen.dostats(wd) == as_lines() == fast
    # every chunk line by line, as the fallback reads it
    monkeypatch.setattr(gen, "_json_values",
                        lambda lines: [json.loads(ln) for ln in lines])
    assert gen.dostats(wd) == as_lines() == fast


def test_a_newline_inside_an_element_is_read_as_json(tmp_path):
    wd = str(tmp_path)
    write_journal(wd, 10, 10, seed=2)
    lines, _ = _odd_lines(wd)
    joined = [lines[0] + lines[1]] + lines[2:]
    with pytest.raises(json.JSONDecodeError):
        gen.dostats(wd, events=joined, mapping=_mapping(wd))
    with pytest.raises(json.JSONDecodeError):
        jax_gen.dostats(wd, events=joined, mapping=_mapping(wd))


@pytest.mark.parametrize("lines", [
    # two values on line 1 and one torn across lines 1 and 2: as many
    # values as lines, if the two lines are read as one text
    [b'{"event_type": "view", "ad_id": "a", "event_time": 1}, '
     b'{"event_type": "view", "ad_id": "a"',
     b'"event_time": 3}'],
    # one line ends inside a list that the next line closes
    [b'{"event_type": "view", "ad_id": "a", "event_time": 1}, '
     b'{"event_type": "view", "ad_id": "a", "x": [{"y": 1}',
     b'{"y": 2}], "event_time": 3}'],
], ids=["torn_after_two", "torn_in_a_list"])
def test_a_torn_journal_raises_as_in_the_reference(tmp_path, lines):
    """Lines that are not one JSON value each raise in both oracles,
    whether the lines come as the caller's events or as the journal."""
    mapping = {"a": "c"}
    for events in (lines, [ln + b"\n" for ln in lines],
                   [ln.decode() for ln in lines]):
        with pytest.raises(json.JSONDecodeError):
            gen.dostats(str(tmp_path), events=events, mapping=mapping)
        with pytest.raises(json.JSONDecodeError):
            jax_gen.dostats(str(tmp_path), events=events, mapping=mapping)
    (tmp_path / gen.KAFKA_JSON_FILE).write_bytes(b"\n".join(lines) + b"\n")
    with pytest.raises(json.JSONDecodeError):
        gen.dostats(str(tmp_path), mapping=mapping)
    with pytest.raises(json.JSONDecodeError):
        jax_gen.dostats(str(tmp_path), mapping=mapping)


@pytest.mark.parametrize("block", [1 << 24, 4096])
def test_journal_file_in_other_forms_equals_jax(tmp_path, monkeypatch,
                                                block):
    """The workdir's journal read in blocks of whole lines (here also
    blocks smaller than a few lines), lines in other forms among the
    generator's, the last line without its newline."""
    monkeypatch.setattr(gen, "_STATS_BLOCK", block)
    wd = str(tmp_path)
    write_journal(wd, 10, 10, seed=4)
    lines, odd = _odd_lines(wd)
    odd = [ln if isinstance(ln, bytes) else ln.encode() for ln in odd]
    blob = b"".join(lines[:1000]) + b"\n".join(odd) + b"\n" + b"".join(
        lines[1000:])
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE), "wb") as f:
        f.write(blob.rstrip(b"\n"))
    got, want = _both(wd)
    assert got == want and got


_OTHER_FORMS = ['{"a-1": "c-1"}', '  {"a-2": "c-2"}', "a-3, c-3", "",
                '{"a-4": "c\\"4"}', '{"a-5": "c-5", "a-6": "c-6"}',
                '{"a-7":"c-7"}', '{"a-1": "c-8"}   ', "\t"]


@pytest.mark.parametrize("extra,added", [
    ([], 0), (_OTHER_FORMS, 7),
    ([ln for ln in _OTHER_FORMS if not ln.startswith("a-3")], 6)],
    ids=["writer_form", "other_forms", "json_forms"])
def test_ad_mapping_file_equals_jax(tmp_path, extra, added):
    """``load_ad_mapping_file``: JSON lines and CSV lines, each as the
    JAX package reads them."""
    wd = str(tmp_path)
    write_journal(wd, 10, 10, seed=6)
    path = os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE)
    with open(path, "a") as f:
        f.write("".join(line + "\n" for line in extra))
    got = gen.load_ad_mapping_file(path)
    assert got == jax_gen.load_ad_mapping_file(path)
    assert len(got) == 1000 + added


def test_a_bad_mapping_line_raises_as_jax(tmp_path):
    wd = str(tmp_path)
    write_journal(wd, 10, 10, seed=6)
    path = os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE)
    with open(path, "a") as f:
        f.write('{"a-1": "c-1"}, {"a-2": "c-2"}\n')
    with pytest.raises(json.JSONDecodeError) as got:
        gen.load_ad_mapping_file(path)
    with pytest.raises(json.JSONDecodeError) as want:
        jax_gen.load_ad_mapping_file(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_ids_equal_jax(seed):
    """The seeded ids: the uuid module's version-4 form of the same
    128-bit draws, as the JAX package makes them."""
    import uuid

    from streambench_tpu.utils.ids import make_ids as jax_make_ids

    got = make_ids(5_000, random.Random(seed))
    assert got == jax_make_ids(5_000, random.Random(seed))
    rng = random.Random(seed)
    assert got[:50] == [str(uuid.UUID(int=rng.getrandbits(128), version=4))
                        for _ in range(50)]


def test_ad_mapping_file_written_as_jax(tmp_path):
    """``write_ad_mapping_file`` writes the JAX package's bytes, quotes,
    escapes and non-ASCII included."""
    campaigns = make_ids(4, random.Random(5)) + ['c"q', "c\\u00e9\\n"]
    ads = make_ids(12, random.Random(6))
    ads[3], ads[7] = "ad\\\\x", "ad\\u2028\\t"
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    want_dir.mkdir()
    got_dir.mkdir()
    want = jax_gen.write_ad_mapping_file(campaigns, ads, str(want_dir))
    got = gen.write_ad_mapping_file(campaigns, ads, str(got_dir))
    assert got == want
    name = gen.AD_TO_CAMPAIGN_FILE
    assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes()
    assert gen.load_ad_mapping_file(str(got_dir / name)) == want
