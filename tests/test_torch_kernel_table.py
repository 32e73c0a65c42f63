"""``chip_smoke.KERNELS`` against the sources it names, on the CPU.

The kernels line that ``chip_smoke.py`` prints states, for each kernel of
the port and each input dtype, its design; these tests hold that table to
the CUDA sources, so the line cannot claim a design the code lacks:

- ``wgmma+tma`` means the named ``csrc`` file defines a ``__global__``
  kernel ``<name>_wgmma`` whose body issues ``wgmma`` products and TMA
  loads, and the C entry point sends that dtype to it; ``+cluster`` means
  the source launches an instantiation of it whose last template argument,
  the cluster size, is above 1, and its body meets the cluster barrier.
- ``simt`` means the file defines ``<name>_simt``, with no ``wgmma`` in its
  body, and the entry point sends that dtype to it.
- ``vec16+persistent`` means every kernel launch in the file (``<<<``)
  launches ``<name>_vec``, a ``__global__`` kernel the file defines, that
  the file has the plain C entry point ``<name>``, that the kernel and the
  ``__device__`` functions it calls move data as 16-byte vectors
  (``float4``, ``uint4`` or ``.v4``), and that the kernel walks its tiles
  with a loop stepping by ``gridDim.x`` (a persistent grid).
- The TPU kernels each entry replaces are Python functions at the lines
  named.
- ``chip_smoke.LAUNCH_SITES`` names, for every kernel, the functions of the
  port whose main paths launch it: each exists, and its body calls the
  kernel's entry (``flash_attention`` for the attention kernels,
  ``fused_apply`` for the update).
"""

import importlib.util
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SMOKE = _chip_smoke()
KERNELS = _SMOKE.KERNELS
LAUNCH_SITES = _SMOKE.LAUNCH_SITES
#: The Python entry each kernel's launch sites call.
_ENTRY = {"flash_fwd": "flash_attention", "flash_bwd_dq": "flash_attention",
          "flash_bwd_dkv": "flash_attention", "fused_update": "fused_apply"}
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
SUFFIX = {"wgmma": "_wgmma", "simt": "_simt", "vec16": "_vec"}
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def _body(text: str, start: int) -> str:
    """The function definition at ``start``, to its closing brace at
    column 0."""
    end = text.index("\n}\n", start)
    return text[start:end + 2]


def _kernel_body(text: str, kernel: str) -> str:
    found = [m for m in _GLOBAL.finditer(text) if m.group(1) == kernel]
    assert found, f"no __global__ kernel {kernel}"
    return _body(text, found[0].start())


def _device_closure(text: str, body: str) -> str:
    """``body`` and, transitively, the bodies of the ``__device__``
    functions of ``text`` it names."""
    defs = {m.group(1): m.start() for m in re.finditer(
        r"__device__\s+__forceinline__\s+[\w:<>]+\s+(\w+)\s*\(", text)}
    seen, todo, out = set(), [body], [body]
    while todo:
        for name in set(re.findall(r"\b(\w+)\s*(?:<[^<>()]*>)?\s*\(",
                                   todo.pop())):
            if name in defs and name not in seen:
                seen.add(name)
                # Every overload of the name.
                for m in re.finditer(
                        rf"__device__\s+__forceinline__\s+[\w:<>]+\s+"
                        rf"{name}\s*\(", text):
                    part = _body(text, m.start())
                    todo.append(part)
                    out.append(part)
    return "\n".join(out)


def _launched_kernels(text: str) -> set[str]:
    """The kernels the file's ``<<<`` launches name, a local alias
    (``auto kernel = f<...>;``) resolved."""
    aliases = dict(re.findall(r"auto\s+(\w+)\s*=\s*(\w+)\s*<", text))
    names = re.findall(r"(\w+)\s*(?:<[^<>]*>)?\s*<<<", text)
    return {aliases.get(n, n) for n in names}


def _launcher_for(text: str, name: str, code: int) -> str:
    """The launcher the C entry point ``name`` calls for dtype ``code``."""
    entry = re.search(rf'extern "C" int {name}\(', text)
    assert entry, f"no C entry point {name}"
    body = _body(text, entry.start())
    calls = re.findall(rf"if \(dtype == {code}\b[^\n]*\n\s*return (\w+)",
                       body)
    assert calls, f"{name} sends dtype {code} nowhere"
    return calls


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in KERNELS for dtype in DTYPE_CODES])
def test_design_matches_source(name, dtype):
    source, _, _, design = KERNELS[name]
    text = (REPO / source).read_text()
    kind, *features = design[dtype].split("+")
    kernel = name + SUFFIX[kind]
    body = _kernel_body(text, kernel)
    if kind == "vec16":
        assert re.search(rf'extern "C" int {name}\(', text), \
            f"no C entry point {name}"
        assert _launched_kernels(text) == {kernel}, \
            f"{source} launches {_launched_kernels(text)}, not {kernel}"
        closure = _device_closure(text, body)
        assert re.search(r"\bfloat4\b|\buint4\b|\.v4\b", closure), \
            f"{kernel} has no 16-byte access"
        if "persistent" in features:
            assert re.search(r"\+=?\s*gridDim\.x", body), \
                f"{kernel} has no grid-stride loop over gridDim.x"
        return
    for launcher in _launcher_for(text, name, DTYPE_CODES[dtype]):
        assert launcher.split("<")[0].endswith(kind), \
            f"{name} sends {dtype} to {launcher}, not to its {kind} kernel"
    if kind == "simt":
        assert "wgmma" not in body
        return
    assert "wgmma_ss_n64" in body or "wgmma_rs_mn" in body
    if "tma" in features:
        assert "tma_load_tile" in body and "mbar_wait" in body
    if "cluster" in features:
        assert "cluster_arrive()" in body and "cluster_wait()" in body
        sizes = re.findall(
            rf"hopper::launch_cluster\(\s*{kernel}<[^<>]*?(\d+)>", text)
        assert any(int(c) > 1 for c in sizes), \
            f"{kernel} is never launched with a cluster of more than 1"


@pytest.mark.parametrize("name,which", [
    (name, i) for name in KERNELS
    for i in range(1 + len(KERNELS[name][2]))])
def test_replaced_tpu_kernel_is_at_the_line_named(name, which):
    _, replaces, also, _ = KERNELS[name]
    path, line = ([replaces] + also)[which].rsplit(":", 1)
    lines = (REPO / path).read_text().splitlines()
    assert re.match(r"\s*def _\w*kernel\(", lines[int(line) - 1]), \
        f"{path}:{line} is not a kernel body: {lines[int(line) - 1]!r}"



def test_every_kernel_has_launch_sites():
    assert set(LAUNCH_SITES) == set(KERNELS) == set(_ENTRY)
    # The window transformer (this slice's families) launches attention.
    assert "sharetrade_tpu_torch/models/transformer.py::transformer_policy" \
        in LAUNCH_SITES["flash_fwd"]


@pytest.mark.parametrize("name,site", [
    (name, site) for name in LAUNCH_SITES for site in LAUNCH_SITES[name]])
def test_launch_site_calls_the_kernel_entry(name, site):
    path, function = site.split("::")
    text = (REPO / path).read_text()
    m = re.search(rf"^def {function}\(", text, re.M)
    assert m, f"{path} defines no top-level {function}"
    nxt = re.search(r"^(def |class )", text[m.end():], re.M)
    body = text[m.start():m.end() + (nxt.start() if nxt else len(text))]
    assert re.search(rf"\b{_ENTRY[name]}\(", body), \
        f"{site} does not call {_ENTRY[name]}"
