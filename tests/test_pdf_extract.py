"""PDF extractor: hex strings, ToUnicode CMaps, CID/Type0 fonts.

Round-2 parity work (VERDICT r1 #7): the reference's PdfPig extractor
(PdfPigTextExtractor.cs:43-56) handles hex-encoded strings and embedded
ToUnicode CMaps; the built-in parser must too.
"""

import zlib

from omni_recall_tpu.extract.pdf import extract_pdf_text


def _pdf(objects: list[bytes]) -> bytes:
    body = b"%PDF-1.4\n"
    for i, obj in enumerate(objects, start=1):
        body += b"%d 0 obj\n" % i + obj + b"\nendobj\n"
    return body + b"%%EOF"


def _stream_obj(content: bytes, compress: bool = False) -> bytes:
    data = zlib.compress(content) if compress else content
    return b"<< /Length %d >>\nstream\n" % len(data) + data + b"\nendstream"


def test_literal_strings_still_extract():
    pdf = _pdf([_stream_obj(b"BT (Hello world) Tj ET")])
    assert extract_pdf_text(pdf) == "Hello world"


def test_hex_string_tj_simple_font():
    # <48656C6C6F> = "Hello"; odd digit count pads a trailing 0 (<59> -> Y)
    pdf = _pdf([_stream_obj(b"BT <48656C6C6F> Tj <5> Tj ET")])
    assert extract_pdf_text(pdf) == "Hello\nP"  # 0x50 = P


def test_hex_strings_inside_tj_array():
    pdf = _pdf([_stream_obj(b"BT [<48 65> -20 (ll) 3 <6F>] TJ ET")])
    assert extract_pdf_text(pdf) == "Hello"


def test_tounicode_cmap_type0_font():
    # CID font: 2-byte codes 0001->T, 0002->P, 0003->U via bfchar
    cmap = (
        b"/CIDInit /ProcSet findresource begin\n"
        b"begincmap\n"
        b"3 beginbfchar\n"
        b"<0001> <0047>\n<0002> <0050>\n<0003> <0055>\n"
        b"endbfchar\nendcmap\nend"
    )
    font = b"<< /Type /Font /Subtype /Type0 /BaseFont /X /ToUnicode 3 0 R >>"
    content = (
        b"<< /Resources << /Font << /F1 2 0 R >> >> >>\n"
        + _stream_obj(b"BT /F1 12 Tf <000100020003> Tj ET")
    )
    pdf = _pdf([content, font, _stream_obj(cmap)])
    assert extract_pdf_text(pdf) == "GPU"


def test_tounicode_bfrange_and_compressed_cmap():
    # bfrange <0010> <0012> <0061> maps to a, b, c; cmap stream is Flate'd
    cmap = (
        b"begincmap\n1 beginbfrange\n<0010> <0012> <0061>\nendbfrange\nendcmap"
    )
    font = b"<< /Type /Font /Subtype /Type0 /ToUnicode 3 0 R >>"
    content = (
        b"<< /Font << /F7 2 0 R >> >>\n"
        + _stream_obj(b"BT /F7 9 Tf [<0010> <0011> <0012>] TJ ET", compress=True)
    )
    pdf = _pdf([content, font, _stream_obj(cmap, compress=True)])
    assert extract_pdf_text(pdf) == "abc"


def test_tounicode_bfrange_array_targets():
    cmap = b"begincmap\n1 beginbfrange\n<01> <02> [<0058> <0059>]\nendbfrange\nendcmap"
    font = b"<< /Type /Font /ToUnicode 3 0 R >>"
    content = b"<< /Font << /F1 2 0 R >> >>\n" + _stream_obj(
        b"BT /F1 1 Tf <0102> Tj ET"
    )
    pdf = _pdf([content, font, _stream_obj(cmap)])
    assert extract_pdf_text(pdf) == "XY"


def test_font_switch_changes_decoding():
    cmap = b"begincmap\n1 beginbfchar\n<0001> <0041>\nendbfchar\nendcmap"
    font = b"<< /Type /Font /Subtype /Type0 /ToUnicode 3 0 R >>"
    content = b"<< /Font << /F1 2 0 R >> >>\n" + _stream_obj(
        b"BT /F1 12 Tf <0001> Tj /F9 10 Tf (plain) Tj ET"
    )
    pdf = _pdf([content, font, _stream_obj(cmap)])
    assert extract_pdf_text(pdf) == "A\nplain"


def test_unmapped_cid_codes_are_dropped_not_garbled():
    cmap = b"begincmap\n1 beginbfchar\n<0001> <0041>\nendbfchar\nendcmap"
    font = b"<< /Type /Font /Subtype /Type0 /ToUnicode 3 0 R >>"
    content = b"<< /Font << /F1 2 0 R >> >>\n" + _stream_obj(
        b"BT /F1 12 Tf <0001FFFF0001> Tj ET"
    )
    pdf = _pdf([content, font, _stream_obj(cmap)])
    assert extract_pdf_text(pdf) == "AA"


def test_decompression_bomb_is_capped():
    """A deflate bomb inside a stream must not expand unboundedly."""
    import zlib

    from omni_recall_tpu.extract.pdf import _MAX_STREAM_BYTES, _decompress

    bomb = zlib.compress(b"\x00" * (_MAX_STREAM_BYTES + (64 << 20)), 9)
    assert len(bomb) < 1 << 20  # tiny on the wire
    out = _decompress(bomb)
    assert len(out) <= _MAX_STREAM_BYTES
