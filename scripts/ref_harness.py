"""Reference-oracle harness: run the UNMODIFIED-semantics reference WITCH
from a clean checkout, for golden-oracle generation and interop checks.

Round-2 VERDICT asked for this to live in scripts/ instead of gitignored
scratch: the committed goldens (tests/golden/ref_*.gz) and the
"reference resumed from our artifacts" interop claim must be
reproducible by one command after an environment wipe.

The reference (c5shen/WITCH @ /root/reference) needs three things this
image lacks, all provided here without altering its behavior:

  * ``dendropy`` — import-only shim.  Every harness entry point runs
    the reference with ``-p <hmmdir>`` (a pre-built decomposition), the
    path on which no dendropy object is ever constructed
    (witch_msa/gcmm/gcmm.py:120-169 skips BackboneJob/decomposition
    when backbone, tree and hmmdir are all supplied).
  * ``psutil`` — real shim over /proc (RSS for memoryUsage; process
    children + kill for the old-witch GCM timeout kill-tree,
    witch_msa/gcmm/aligner.py:245-252).
  * ``Configs.gcm_path`` — restored attribute.  Upstream v1.0.10
    comments it out (configs.py:68) while aligner.py:218 still reads
    it, so old-witch mode crashes with AttributeError in the original;
    the value itself is never used (only magus_path matters).

The decomposition handed to ``-p`` is generated by OUR pipeline
(--keep-decomposition writes the reference's A_0_* layout,
witch_tpu/ensemble.py) and then — for full reference fidelity — the
``.hmm`` models and ``hmmsearch.results.*`` files are REGENERATED with
the reference's bundled HMMER binaries (``hmmdir --rebuild``), so every
number the reference consumes afterwards came from its own engines.
Subset membership equivalence is separately guarded by the committed
goldens (scenario-D 1000/1000) and the -p interop tests.

Usage (from a clean checkout; ~10 min total on 4 cores):

    # 1. patched reference copy + shims under /tmp/refwork
    python scripts/ref_harness.py setup /tmp/refwork

    # 2. decomposition + reference-native hmmbuild/hmmsearch artifacts
    python scripts/ref_harness.py hmmdir /tmp/refwork --rebuild

    # 3a. reference witch-ng oracle on the example queries
    python scripts/ref_harness.py run /tmp/refwork -d /tmp/refwork/out_d \
        -q /root/reference/examples/data/unaligned_frag.fasta

    # 3b. reference old-witch (GCM) oracle
    python scripts/ref_harness.py run /tmp/refwork -d /tmp/refwork/out_ow \
        -q /root/reference/examples/data/unaligned_frag.fasta \
        --mode old-witch

    # 4. interop: reference resumed from OUR artifacts (no --rebuild),
    #    output must equal its own native run (grade with a diff)
    python scripts/ref_harness.py hmmdir /tmp/refwork_ours
    python scripts/ref_harness.py run /tmp/refwork_ours -d \
        /tmp/refwork_ours/out_d -q \
        /root/reference/examples/data/unaligned_frag.fasta
"""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REF = "/root/reference"
DATA = os.path.join(REF, "examples", "data")

PSUTIL_SHIM = '''\
"""Minimal /proc-backed psutil shim for the reference WITCH.

Covers the two uses: memoryUsage RSS (helpers/general_tools.py:5-8) and
the old-witch GCM timeout kill-tree (gcmm/aligner.py:245-252)."""
import os
import signal


class NoSuchProcess(Exception):
    pass


class Process:
    def __init__(self, pid=None):
        self.pid = os.getpid() if pid is None else int(pid)
        if not os.path.isdir("/proc/%d" % self.pid):
            raise NoSuchProcess(self.pid)

    def memory_info(self):
        class MI:
            rss = 0
        mi = MI()
        try:
            with open("/proc/%d/statm" % self.pid) as f:
                mi.rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except OSError:
            pass
        return mi

    def children(self, recursive=False):
        table = {}
        for d in os.listdir("/proc"):
            if not d.isdigit():
                continue
            try:
                with open("/proc/%s/stat" % d) as f:
                    parts = f.read().rsplit(")", 1)[1].split()
                table.setdefault(int(parts[1]), []).append(int(d))
            except OSError:
                continue
        out, stack = [], [self.pid]
        while stack:
            p = stack.pop()
            for c in table.get(p, []):
                out.append(Process(c))
                if recursive:
                    stack.append(c)
        return out

    def kill(self):
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            raise NoSuchProcess(self.pid)

    def terminate(self):
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            raise NoSuchProcess(self.pid)
'''

DENDROPY_SHIM = '''\
"""Import-only dendropy shim: the -p (pre-built hmmdir) path never
constructs a tree (witch_msa/gcmm/gcmm.py:120-169), but several modules
import dendropy names at module scope.  Any actual use raises."""


class _Unusable:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "dendropy shim: tree construction is not available; "
            "run the reference with -p <hmmdir> (see scripts/ref_harness.py)")

    @classmethod
    def get_from_stream(cls, *a, **k):
        raise NotImplementedError("dendropy shim")

    get = get_from_stream


class Tree(_Unusable):
    pass


class Taxon(_Unusable):
    pass


class DataSet(_Unusable):
    pass


class treecalc:
    pass
'''


def setup(workdir):
    os.makedirs(workdir, exist_ok=True)
    dst = os.path.join(workdir, "ref")
    if not os.path.isdir(dst):
        os.makedirs(dst)
        # python tree copied (it gets patched); 52M tools dir symlinked
        src_pkg = os.path.join(REF, "witch_msa")
        dst_pkg = os.path.join(dst, "witch_msa")
        shutil.copytree(src_pkg, dst_pkg,
                        ignore=shutil.ignore_patterns("tools"))
        os.symlink(os.path.join(src_pkg, "tools"),
                   os.path.join(dst_pkg, "tools"))
        shutil.copy(os.path.join(REF, "witch.py"), dst)
    # restore the commented-out Configs.gcm_path (upstream crash fix)
    cfg = os.path.join(dst, "witch_msa", "configs.py")
    txt = open(cfg).read()
    if "\n    gcm_path = None\n" not in txt:
        anchor = "class Configs:\n"
        txt = txt.replace(anchor, anchor + "    gcm_path = None\n", 1)
        open(cfg, "w").write(txt)
    # shims importable ahead of site-packages
    shims = os.path.join(workdir, "shims")
    os.makedirs(os.path.join(shims, "dendropy", "datamodel"), exist_ok=True)
    open(os.path.join(shims, "psutil.py"), "w").write(PSUTIL_SHIM)
    dd = os.path.join(shims, "dendropy")
    open(os.path.join(dd, "__init__.py"), "w").write(DENDROPY_SHIM)
    open(os.path.join(dd, "datamodel", "__init__.py"), "w").write("")
    open(os.path.join(dd, "datamodel", "treemodel.py"), "w").write(
        "from dendropy import Tree\n")
    open(os.path.join(dd, "datamodel", "taxonmodel.py"), "w").write(
        "from dendropy import Taxon\n")
    # vendored MAGUS (old-witch GCM mode) imports
    # dendropy.utility.bitprocessing at module load
    # (magus/helpers/treeutils.py:8) but never calls it on the
    # `-s constraints -b backbones` path WITCH uses — import-only stub
    os.makedirs(os.path.join(dd, "utility"), exist_ok=True)
    open(os.path.join(dd, "utility", "__init__.py"), "w").write("")
    open(os.path.join(dd, "utility", "bitprocessing.py"), "w").write(
        "def num_set_bits(*a, **k):\n"
        "    raise NotImplementedError('shim')\n")
    os.makedirs(os.path.join(workdir, "home"), exist_ok=True)
    print("setup: patched reference at %s" % dst)
    return dst


def ref_env(workdir):
    env = dict(os.environ)
    env["HOME"] = os.path.join(workdir, "home")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(workdir, "shims"), os.path.join(workdir, "ref")])
    return env


def build_hmmdir(workdir, rebuild=False, backbone=None, tree=None,
                 queries=None, molecule="dna"):
    """Write the A_0_* decomposition with our pipeline, then (with
    --rebuild) regenerate models + search results via reference HMMER."""
    backbone = backbone or os.path.join(DATA, "backbone.aln.fasta.gz")
    tree = tree or os.path.join(DATA, "backbone.tre")
    queries = queries or os.path.join(DATA, "unaligned_frag.fasta")
    outdir = os.path.join(workdir, "ours_d")
    hmmdir = os.path.join(outdir, "tree_decomp", "root")
    if not os.path.isdir(hmmdir):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-m", "witch_tpu", "-b", backbone, "-e", tree,
             "-q", queries, "-d", outdir, "-o", "aligned.fasta",
             "--keep-decomposition", "1", "--full-search-results", "1",
             "--molecule", molecule],
            cwd=REPO, env=env, check=True)
    if not rebuild:
        print("hmmdir: our artifacts at %s" % hmmdir)
        return hmmdir
    hmmer = os.path.join(REF, "witch_msa", "tools", "magus", "tools",
                         "hmmer")
    subsets = sorted(
        (d for d in os.listdir(hmmdir) if d.startswith("A_0_")),
        key=lambda s: int(s.split("_")[-1]))
    # rebuild every model with the reference hmmbuild
    from concurrent.futures import ThreadPoolExecutor

    def rebuild_one(name):
        d = os.path.join(hmmdir, name)
        fasta = os.path.join(d, "hmmbuild.input.%s.fasta" % name)
        model = os.path.join(d, "hmmbuild.model.%s" % name)
        mol = {"dna": "--dna", "rna": "--rna", "amino": "--amino"}[molecule]
        r = subprocess.run(
            [os.path.join(hmmer, "hmmbuild"), "--cpu", "1", mol,
             "--ere", "0.59", "--symfrac", "0.0", "--informat", "afa",
             model, fasta], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-400:]
        # reference hmmsearch over the full query set
        res = subprocess.run(
            [os.path.join(hmmer, "hmmsearch"), "--cpu", "1", "--noali",
             "-E", "99999999", "--max", model, queries],
            capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-400:]
        # exact transcription of the reference's evalHMMSearchOutput
        # parse (witch_msa/gcmm/algorithm.py:579-605): 9 whitespace
        # fields after the "E-value" header line, stop at first blank
        import re
        pattern = re.compile(
            r"([^\s]+)\s+([^\s]+)\s+([^\s]+)\s+([^\s]+)\s+([^\s]+)\s+"
            r"([^\s]+)\s+([^\s]+)\s+([^\s]+)\s+([^\s]+)")
        scores = {}
        start_reading = False
        for line in res.stdout.splitlines():
            line = line.strip()
            if not start_reading and line.startswith("E-value"):
                start_reading = True
            elif start_reading and line == "":
                break
            elif start_reading:
                m = pattern.search(line)
                if m is not None and m.group(0).find("--") == -1:
                    scores[m.group(9).strip()] = (
                        float(m.group(1)), float(m.group(2)))
        # persisted in the reference's literal-dict format
        for f in os.listdir(d):
            if f.startswith("hmmsearch.results."):
                os.unlink(os.path.join(d, f))
        with open(os.path.join(
                d, "hmmsearch.results.%s.fragment_chunk_0" % name),
                "w") as f:
            f.write(str(scores))
        return name

    with ThreadPoolExecutor(max_workers=4) as ex:
        for name in ex.map(rebuild_one, subsets):
            pass
    print("hmmdir: reference-native artifacts at %s" % hmmdir)
    return hmmdir


def run_ref(workdir, extra):
    dst = os.path.join(workdir, "ref")
    hmmdir = os.path.join(workdir, "ours_d", "tree_decomp", "root")
    backbone = os.path.join(DATA, "backbone.aln.fasta.gz")
    args = [sys.executable, os.path.join(dst, "witch.py"),
            "--num-cpus", "4", "-b", backbone, "-p", hmmdir] + extra
    print("+ " + " ".join(args))
    r = subprocess.run(args, env=ref_env(workdir))
    raise SystemExit(r.returncode)


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        raise SystemExit(2)
    cmd, workdir = sys.argv[1], os.path.abspath(sys.argv[2])
    if cmd == "setup":
        setup(workdir)
    elif cmd == "hmmdir":
        setup(workdir)
        rebuild = "--rebuild" in sys.argv[3:]
        kw = {}
        for a in sys.argv[3:]:
            if a.startswith("--queries="):
                kw["queries"] = a.split("=", 1)[1]
            if a.startswith("--molecule="):
                kw["molecule"] = a.split("=", 1)[1]
        build_hmmdir(workdir, rebuild=rebuild, **kw)
    elif cmd == "run":
        run_ref(workdir, sys.argv[3:])
    else:
        print(__doc__)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
