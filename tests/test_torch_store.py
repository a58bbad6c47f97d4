"""The port's store copies (``store/directory.py``, ``store/codecs.py``) vs
the JAX package's, on the CPU.

Each package reads what the other wrote, byte for byte: every codec of the
registry (``none``, ``zlib``, ``lz4``, ``lz4dict`` with its carried
dictionary, ``delta``), every cipher (whole files and random-access
ranges), the directories (memory, file system, mmap; locks across the two)
and the directory wrappers (encrypted, asynchronous, caching). Segments the
JAX writer wrote with ``lz4``, ``lz4dict`` or ``delta`` columns open in the
port through ``carry_segment`` with the same column values, also through
an encrypted directory, and the port's ``write_segment`` with those codecs
gives the JAX package's bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.index.reader import DirectoryReader, read_meta  # noqa: E402
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions  # noqa: E402
from iresearch_tpu.search import filters as F  # noqa: E402
from iresearch_tpu.store import codecs as jc  # noqa: E402
from iresearch_tpu.store import directory as jd  # noqa: E402
from iresearch_tpu_torch.index.segment import carry_segment  # noqa: E402
from iresearch_tpu_torch.store import codecs as pc  # noqa: E402
from iresearch_tpu_torch.store import directory as pd  # noqa: E402

_RNG = np.random.default_rng(3)
PAYLOADS = [
    b"",
    b"x",
    bytes(range(256)) * 40,
    np.arange(5000, dtype=np.uint64).tobytes(),
    np.cumsum(_RNG.integers(-9, 40, 3000)).astype(np.uint64).tobytes(),
    _RNG.integers(0, 256, 12345, dtype=np.uint8).tobytes(),
    b"abc" * 1001 + b"z",
]
CODECS = ["none", "zlib", "lz4", "lz4dict", "delta"]
CIPHERS = {
    "rot13": lambda m: m.Rot13Cipher(),
    "xorctr": lambda m: m.XorCtrCipher(b"k" * 16),
    "aes128": lambda m: m.AesCtrCipher(b"secret key bytes"),
    "aes256": lambda m: m.AesCtrCipher(b"a longer passphrase than sixteen"),
}


@pytest.mark.parametrize("name", CODECS)
def test_codec_reads_the_other_packages_bytes(name):
    """Both packages compress every payload to the same bytes and each
    decompresses the other's; ``lz4dict`` also against its dictionary."""
    if name.startswith("lz4") and jc._LZ4 is None:
        for m in (jc, pc):
            with pytest.raises(RuntimeError, match="liblz4"):
                m.get_compressor(name)
        return
    j, p = jc.get_compressor(name), pc.get_compressor(name)
    assert type(p).__name__ == type(j).__name__ and p.name == j.name == name
    for data in PAYLOADS:
        cj, cp = j.compress(data), p.compress(data)
        assert cp == cj, (name, len(data))
        assert p.decompress(cj) == data and j.decompress(cp) == data
    if getattr(j, "dict_blocks", False):
        assert p.dict_blocks
        d0 = PAYLOADS[2]
        for data in PAYLOADS[1:]:
            cj = j.compress_with_dict(data, d0)
            assert p.compress_with_dict(data, d0) == cj
            assert p.decompress_with_dict(cj, d0) == data


def test_registry_and_missing_libraries(monkeypatch):
    """``register_compressor`` adds a codec; an unknown name raises
    ``KeyError``; without liblz4 or libcrypto the codecs and the AES
    cipher raise what the JAX package raises."""

    class Rev(pc.Compressor):
        name = "rev"

        def compress(self, data):
            return data[::-1]

        decompress = compress

    pc.register_compressor("rev", lambda a: Rev())
    try:
        assert pc.get_compressor("rev").compress(b"abc") == b"cba"
    finally:
        pc._COMPRESSORS.pop("rev")
    for m in (jc, pc):
        with pytest.raises(KeyError, match="unknown compression"):
            m.get_compressor("rev")
        monkeypatch.setattr(m, "_LZ4", None)
        monkeypatch.setattr(m, "_CRYPTO", None)
    for fn in (lambda m: m.get_compressor("lz4"), lambda m: m.Lz4DictCompressor(),
               lambda m: m.AesCtrCipher(b"k" * 16)):
        errs = []
        for m in (jc, pc):
            with pytest.raises(RuntimeError) as e:
                fn(m)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("name", sorted(CIPHERS))
def test_cipher_reads_the_other_packages_bytes(name):
    """Equal ciphertexts per file name; each decrypts the other's, whole
    and from any offset (``decrypt_at``)."""
    j, p = CIPHERS[name](jc), CIPHERS[name](pc)
    assert p.random_access == j.random_access
    rng = np.random.default_rng(5)
    for data in PAYLOADS:
        for fname in ("_1.seg", "segments_2"):
            ej = j.encrypt(fname, data)
            assert p.encrypt(fname, data) == ej
            assert p.decrypt(fname, ej) == data and j.decrypt(fname, p.encrypt(fname, data)) == data
            for _ in range(4):
                if not data:
                    break
                o = int(rng.integers(0, len(data)))
                n = int(rng.integers(0, len(data) - o + 1))
                assert p.decrypt_at(fname, ej[o:o + n], o) == data[o:o + n]


@pytest.mark.parametrize("kind", ["FSDirectory", "MMapDirectory"])
def test_directories_share_files_and_locks(tmp_path, kind):
    """A file-system directory of either package reads, lists, renames and
    removes the other's files, and the lock of one excludes the other."""
    j, p = getattr(jd, kind)(str(tmp_path)), getattr(pd, kind)(str(tmp_path))
    for i, data in enumerate(PAYLOADS):
        j.write(f"f{i}", data)
    assert sorted(p.list()) == sorted(j.list())
    for i, data in enumerate(PAYLOADS):
        assert p.read(f"f{i}") == data and p.length(f"f{i}") == len(data)
        assert bytes(p.read_mapped(f"f{i}")) == bytes(j.read_mapped(f"f{i}"))
    p.rename("f2", "g2")
    assert j.exists("g2") and not j.exists("f2") and j.read("g2") == PAYLOADS[2]
    removed = pd.clean_directory(p, {"f1", "g2"})
    assert sorted(removed) == sorted(f"f{i}" for i in range(len(PAYLOADS)) if i not in (1, 2))
    assert sorted(j.list()) == ["f1", "g2"]
    with j.lock():
        assert p.try_lock() is None
        with pytest.raises(pd.LockObtainError):
            p.lock()
    with p.lock():
        assert j.try_lock() is None


def test_memory_directory_matches_jax():
    """The memory directory and ``clean_directory`` behave as the JAX
    package's on the same calls."""
    j, p = jd.MemoryDirectory(), pd.MemoryDirectory()
    for d in (j, p):
        for i, data in enumerate(PAYLOADS):
            d.write(f"f{i}", data)
        d.rename("f0", "h0")
        d.sync(["h0"])
        lk = d.try_lock()
        assert lk is not None and d.try_lock() is None
        lk.release()
    assert sorted(p.list()) == sorted(j.list())
    assert all(p.read(n) == j.read(n) and p.length(n) == j.length(n) for n in j.list())
    assert pd.clean_directory(p, {"h0"}) == jd.clean_directory(j, {"h0"})
    assert p.list() == j.list() == ["h0"]


@pytest.mark.parametrize("name", sorted(CIPHERS))
def test_wrappers_read_the_other_packages_files(tmp_path, name):
    """Files the JAX package writes through its encrypted, asynchronous
    and caching wrappers read back through the port's over the same
    directory, byte for byte (lazily decrypted ranges too), and the
    reverse."""
    jcip, pcip = CIPHERS[name](jc), CIPHERS[name](pc)
    jdir = jc.CachingDirectory(jc.AsyncDirectory(
        jc.EncryptedDirectory(jd.MMapDirectory(str(tmp_path)), jcip)))
    pdir = pc.CachingDirectory(pc.AsyncDirectory(
        pc.EncryptedDirectory(pd.MMapDirectory(str(tmp_path)), pcip)))
    for i, data in enumerate(PAYLOADS):
        jdir.write(f"j{i}", data)
    jdir.sync([f"j{i}" for i in range(len(PAYLOADS))])
    pdir.write("p0", PAYLOADS[3])
    pdir.sync(["p0"])
    for i, data in enumerate(PAYLOADS):
        assert pdir.read(f"j{i}") == data and pdir.length(f"j{i}") == len(data)
    assert jdir.read("p0") == PAYLOADS[3]
    assert sorted(pdir.list()) == sorted(jdir.list())
    enc_p = pc.EncryptedDirectory(pd.MMapDirectory(str(tmp_path)), pcip)
    lazy = enc_p.read_mapped("j5")
    assert isinstance(lazy, pc.LazyDecryptBuffer) == jcip.random_access
    assert bytes(lazy[100:2000]) == PAYLOADS[5][100:2000] and len(lazy) == len(PAYLOADS[5])
    for d in (jdir, pdir):
        d.inner.close()


def _jax_index(d, codec):
    """A JAX index in ``d``: 300 docs with a stored ``id`` and a stored
    ``note`` column compressed with ``codec``, doc 7 deleted, two
    segments."""
    rng = np.random.default_rng(13)
    words = ["alpha", "beta", "gamma", "delta", "eps"]
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy", column_compression=codec)) as w:
        for i in range(300):
            text = " ".join(words[j] for j in rng.integers(0, 5, int(rng.integers(2, 9))))
            w.insert([
                Field("body", text, analyzer="segmentation"),
                Field("id", str(i), index=True, store=True),
                Field("note", f"note {i} " + text * 3, index=False, store=True),
            ])
            if i == 149:
                w.commit()
        w.commit()
        w.remove(F.ByTerm("id", "7"))
        w.commit()


@pytest.mark.parametrize("encrypted", [False, True], ids=["plain", "aes"])
@pytest.mark.parametrize("codec", ["lz4", "lz4dict", "delta"])
def test_jax_compressed_segments_open_in_port(codec, encrypted):
    """The codec fault: a segment the JAX writer wrote with ``lz4``,
    ``lz4dict`` or ``delta`` columns opens through ``carry_segment`` with
    the same columns, term dictionary and deletes (through an encrypted
    directory too: the port's wrapper decrypts the JAX package's file);
    the port's ``write_segment`` with the same codec gives the JAX
    package's bytes."""
    from iresearch_tpu.formats.segment_io import write_segment as jax_write
    from iresearch_tpu_torch.formats.segment_io import write_segment

    raw = jd.MemoryDirectory()
    d = jc.EncryptedDirectory(raw, jc.AesCtrCipher(b"k" * 16)) if encrypted else raw
    _jax_index(d, codec)
    reader = DirectoryReader.open(d)
    port_raw = pd.MemoryDirectory()
    for n in raw.list():
        port_raw.write(n, raw.read(n))
    port_dir = (pc.EncryptedDirectory(port_raw, pc.AesCtrCipher(b"k" * 16))
                if encrypted else port_raw)
    infos = read_meta(d).segments
    assert len(infos) == len(reader.segments) == 2
    for info, jsr in zip(infos, reader.segments):
        psr = carry_segment(info.name, port_dir.read(info.file), np.flatnonzero(~jsr.alive))
        assert psr.num_docs == jsr.num_docs and psr.live_docs_count == jsr.live_docs_count
        assert sorted(psr.column_names()) == sorted(jsr.data.columns)
        for name, jcol in jsr.data.columns.items():
            assert list(psr.column(name).items()) == list(jcol.items()), name
        assert list(psr.terms("body")) == list(jsr.terms("body"))
        assert write_segment(psr.data, codec) == jax_write(jsr.data, codec)
    assert not reader.segments[0].alive[7]
