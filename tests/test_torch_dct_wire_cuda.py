"""The DCT wire's decode on a card against the same decode on the CPU.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
  python -m pytest tests/test_torch_dct_wire_cuda.py -q

Held: the integer coefficients bitwise; the planes within |Δ| ≤ 1 in at
most ``PLANE_SHARE`` of the values (float32 matmuls of the IDCT and the
resize sum in another order on the card); no copy or wait between host and
card in the step once its constants are on the card; and the DCT wire's
pipeline on the card equal to the same pipeline on the CPU within that
tolerance.
"""

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.bench_pipeline import build_pipeline
from accvlab_tpu_torch.pipeline.inputs.multicam_jpeg import encode_bench_jpegs
from accvlab_tpu_torch.pipeline.processing_steps import DCTWirePacker, DCTWireUnpacker

PLANE_SHARE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def packed_batch(src, out, n, grouping="split12"):
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup

    packer = DCTWirePacker("image", src, out, grouping=grouping)
    samples = []
    for j in encode_bench_jpegs(n, src):
        s = SampleDataGroup()
        s.add_data_field("image", DType.UINT8)
        s["image"] = j
        samples.append(s)
    samples = packer._process_batch(samples)
    names = samples[0].field_names_flat
    fields = {}
    for name in names:
        t = torch.from_numpy(np.stack([np.asarray(s[name]) for s in samples]))
        fields[name[len("image_"):]] = t.view(torch.int32) if t.dtype == torch.uint32 else t
    return fields


@pytest.mark.cuda
@pytest.mark.parametrize("src,out", [((372, 1024), (256, 704)), ((744, 2048), (512, 1408)),
                                     ((96, 256), (24, 64))])
def test_decode_on_the_card_equals_the_cpu(cuda, src, out):
    fields = packed_batch(src, out, 4)
    unpacker = DCTWireUnpacker("image", src, out)
    on_card = {k: v.to(cuda) for k, v in fields.items()}
    coef_cpu = unpacker.coefficients(fields.__getitem__)
    coef_card = unpacker.coefficients(on_card.__getitem__)
    for cs in coef_cpu:
        assert torch.equal(coef_card[cs].cpu(), coef_cpu[cs]), cs
    for got, want in zip(unpacker.decode_fields(on_card.__getitem__),
                         unpacker.decode_fields(fields.__getitem__)):
        d = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= PLANE_SHARE


@pytest.mark.cuda
def test_decode_makes_no_host_sync(cuda):
    fields = {k: v.to(cuda) for k, v in packed_batch((372, 1024), (256, 704), 2).items()}
    unpacker = DCTWireUnpacker("image", (372, 1024), (256, 704))
    unpacker.decode_fields(fields.__getitem__)  # the constants go to the card once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, cbcr = unpacker.decode_fields(fields.__getitem__)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert y.is_cuda and tuple(cbcr.shape) == (2, 128, 352, 2)


@pytest.mark.cuda
def test_dct_pipeline_on_the_card_matches_the_cpu(cuda):
    kw = dict(batch_size=2, num_threads=2, hw=(96, 256), num_cams=2, out_hw=(64, 176),
              heatmap_hw=(16, 44), num_samples=4, num_unique=2, affine_prob=0.0,
              photometric_prob=0.0)
    outs = {}
    for dev in ("cpu", cuda):
        pipe = build_pipeline(device=dev, **kw)
        try:
            outs[str(dev)] = {k: v.cpu() for k, v in pipe.run().items()}
        finally:
            pipe.stop()
    cpu, card = outs["cpu"], outs[str(cuda)]
    for name, want in cpu.items():
        got = card[name]
        if name.endswith(".image"):  # 4 levels over the smallest std (test_torch_dct_wire.py)
            assert float((got - want).abs().max()) <= 4 / 57.1 + 1e-5, name
            assert float((got != want).float().mean()) < 0.01, name
        elif name.endswith("heatmap"):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        else:
            assert torch.equal(got, want), name
