import pytest
import torch


@pytest.fixture
def card():
    """Skips a `cuda` test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures the card)")


@pytest.fixture
def f32_port(monkeypatch):
    """The drivers build the port's model computing in float32."""
    from benchmark.tests import tiny
    from benchmark.traffic import infer, train

    build_train, build_infer = train.build, infer.build

    def train_build(run, device):
        out = build_train(run, device)
        tiny.to_f32(out[0])
        return out

    def infer_build(run, device):
        fn, w = build_infer(run, device)
        for cell in fn.__closure__:
            if isinstance(cell.cell_contents, torch.nn.Module):
                tiny.to_f32(cell.cell_contents)
        return fn, w
    monkeypatch.setattr(train, "build", train_build)
    monkeypatch.setattr(infer, "build", infer_build)
