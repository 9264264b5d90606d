"""PHYLIP-style interactive menu (≙ interface.c: Launch_Interface
interface.c:15 and its sub-menus Launch_Interface_Data_Type /
_Model / _Topo_Search / _Branch_Support).

The reference drops into this terminal menu whenever `phyml` is run
without command-line options (io.c:4373-4384): toggle keys flip
settings, '+'/'-' page between the four sub-menus, 'Y' launches the
run.  Here the menu fills the same argparse namespace the CLI
builds, so both front ends configure one analysis path (the
reference's design: three front ends writing one `option` struct,
SURVEY.md §5).

Port of phyml_tpu/interface.py: the same keys, screens and namespace.
The namespace comes from this port's parser, whose defaults include
`--platform gpu`, so a menu run takes the CUDA device.

Streams are injectable for tests (`instream` an iterable of lines).
"""

from __future__ import annotations

import sys

PAGES = ["input", "model", "search", "support"]

NT_MODELS = ["JC69", "K80", "F81", "HKY85", "F84", "TN93", "GTR"]
AA_MODELS = ["LG", "WAG", "JTT", "Dayhoff", "DCMut", "RtREV", "CpREV",
             "VT", "Blosum62", "MtMam", "MtArt", "HIVw", "HIVb", "AB",
             "MtREV"]


class MenuState:
    def __init__(self, input_file: str):
        self.input_file = input_file
        self.datatype = "nt"
        self.sequential = False
        self.n_data_sets = 1
        self.model_idx = 3            # HKY85 (reference default)
        self.aa_model_idx = 0         # LG
        self.freqs = None             # None = reference default
        self.ts_tv = "e"
        self.n_classes = 4
        self.alpha = "e"
        self.pinv = "0.0"
        self.optimize = "tlr"
        self.search = "NNI"
        self.user_tree = None
        self.rand_start = False
        self.n_rand_starts = 5
        self.bootstrap = 0            # 0 none; >0 reps; <0 aLRT family
        self.tbe = False

    @property
    def model(self) -> str:
        return (NT_MODELS[self.model_idx] if self.datatype == "nt"
                else AA_MODELS[self.aa_model_idx])

    def to_args(self):
        """argparse namespace for cli.run_analysis (the parser's
        defaults for every flag the menu does not set)."""
        from phyml_tpu_torch.cli import build_parser
        argv = ["-i", self.input_file, "-d", self.datatype,
                "-m", self.model, "-c", str(self.n_classes),
                "-a", str(self.alpha), "-v", str(self.pinv),
                "-o", self.optimize, "-s", self.search,
                "-b", str(self.bootstrap), "-t", str(self.ts_tv),
                "-n", str(self.n_data_sets)]
        if self.sequential:
            argv.append("-q")
        if self.freqs:
            argv += ["-f", self.freqs]
        if self.user_tree:
            argv += ["-u", self.user_tree]
        if self.rand_start:
            argv += ["--rand_start",
                     "--n_rand_starts", str(self.n_rand_starts)]
        if self.tbe:
            argv.append("--tbe")
        return build_parser().parse_args(argv)


def _fmt_bool(b):
    return "yes" if b else "no"


def _render(st: MenuState, page: str, out) -> None:
    bar = " " + "o" * 76
    out.write("\n\n" + bar + "\n")
    title = {
        "input": "Input Data",
        "model": "Substitution Model",
        "search": "Tree Searching",
        "support": "Branch Support",
    }[page]
    out.write(f"{'Menu : ' + title:^78}\n")
    out.write(" " + "." * 76 + "\n\n")
    w = lambda key, desc, val: out.write(
        f"                [{key}] "
        f"{'.' * 40} {desc}  {val}\n")
    if page == "input":
        w("D", "Data type (DNA/AA/generic) ", st.datatype.upper())
        w("I", "Input sequences interleaved (or sequential) ",
          _fmt_bool(not st.sequential))
        w("M", "Analyze multiple data sets ", st.n_data_sets)
    elif page == "model":
        w("M", "Model of substitution ", st.model)
        if st.datatype == "nt" and st.model in (
                "K80", "HKY85", "F84", "TN93"):
            w("T", "Ts/tv ratio (fixed/estimated) ", st.ts_tv)
        w("F", "Base frequency estimates "
          "(empirical/ML/model) ", st.freqs or "default")
        w("R", "One category of substitution rate (yes/no) ",
          _fmt_bool(st.n_classes == 1))
        if st.n_classes > 1:
            w("C", "Number of substitution rate categories ",
              st.n_classes)
            w("A", "Gamma shape parameter (fixed/estimated) ",
              st.alpha)
        w("V", "Proportion of invariable sites (fixed/estimated)",
          st.pinv)
    elif page == "search":
        w("O", "Optimise tree topology ",
          _fmt_bool("t" in st.optimize))
        if "t" in st.optimize:
            w("S", "Tree topology search operations ", st.search)
            w("R", "Use random starting tree ",
              _fmt_bool(st.rand_start))
            if st.rand_start:
                w("N", "Number of random starting trees ",
                  st.n_rand_starts)
        w("U", "Starting tree (BioNJ/user tree) ",
          st.user_tree or "BioNJ")
        w("L", "Optimise branch lengths ",
          _fmt_bool("l" in st.optimize))
        w("M", "Optimise substitution model parameters ",
          _fmt_bool("r" in st.optimize))
    else:
        val = {0: "no", -1: "aLRT statistics", -2: "Chi2-based aLRT",
               -4: "SH-like aLRT", -5: "aBayes"}.get(
                   st.bootstrap,
                   f"yes ({st.bootstrap} replicates"
                   + (", TBE" if st.tbe else "") + ")")
        w("B", "Non parametric bootstrap analysis / aLRT ", val)
    out.write("\n\n. Are these settings correct? "
              "(type '+', '-', flag key or 'Y' to launch) ")
    out.flush()


def _toggle(st: MenuState, page: str, key: str, readline) -> None:
    key = key.upper()
    if page == "input":
        if key == "D":
            # cycle nt -> aa -> generic -> nt (interface.c:530-551)
            st.datatype = {"nt": "aa", "aa": "generic",
                           "generic": "nt"}[st.datatype]
        elif key == "I":
            st.sequential = not st.sequential
        elif key == "M":
            st.n_data_sets = int(readline("How many data sets > "))
    elif page == "model":
        if key == "M":
            if st.datatype == "nt":
                st.model_idx = (st.model_idx + 1) % len(NT_MODELS)
            else:
                st.aa_model_idx = (st.aa_model_idx + 1) % len(AA_MODELS)
        elif key == "T":
            st.ts_tv = readline(
                "Ts/tv ratio (or 'e' to estimate) > ").strip()
        elif key == "F":
            order = [None, "e", "m", "o"]
            st.freqs = order[(order.index(st.freqs) + 1) % len(order)]
        elif key == "R":
            st.n_classes = 1 if st.n_classes > 1 else 4
        elif key == "C":
            st.n_classes = int(readline(
                "Number of rate categories > "))
        elif key == "A":
            st.alpha = readline(
                "Gamma shape (or 'e' to estimate) > ").strip()
        elif key == "V":
            st.pinv = readline(
                "Proportion invariant (or 'e') > ").strip()
    elif page == "search":
        if key == "O":
            st.optimize = ("lr" if "t" in st.optimize else "tlr")
        elif key == "S":
            order = ["NNI", "SPR", "BEST"]
            st.search = order[(order.index(st.search) + 1) % 3]
        elif key == "R":
            st.rand_start = not st.rand_start
        elif key == "N":
            st.n_rand_starts = int(readline(
                "Number of random starting trees > "))
        elif key == "U":
            st.user_tree = readline(
                "Starting tree file (empty = BioNJ) > ").strip() \
                or None
        elif key == "L":
            st.optimize = st.optimize.replace("l", "") \
                if "l" in st.optimize else st.optimize + "l"
        elif key == "M":
            st.optimize = st.optimize.replace("r", "") \
                if "r" in st.optimize else st.optimize + "r"
    else:
        if key == "B":
            order = [0, -1, -2, -4, -5, 100]
            cur = st.bootstrap if st.bootstrap in order else 100
            st.bootstrap = order[(order.index(cur) + 1) % len(order)]
            if st.bootstrap == 100:
                st.bootstrap = int(readline(
                    "Number of bootstrap replicates > "))
                st.tbe = readline(
                    "Transfer bootstrap (TBE)? (y/n) > "
                ).strip().lower().startswith("y")


def launch_interface(input_file: str | None = None, instream=None,
                     outstream=None, run: bool = True) -> int:
    """Interactive configuration, then (optionally) run the analysis.
    Returns the analysis exit code, or 0 when run=False (tests)."""
    out = outstream or sys.stdout
    lines = iter(instream) if instream is not None else None

    def readline(prompt: str = "") -> str:
        if prompt:
            out.write(prompt)
            out.flush()
        if lines is not None:
            try:
                return next(lines).rstrip("\n")
            except StopIteration:
                raise EOFError("interactive input exhausted")
        return input()

    if input_file is None:
        input_file = readline(
            ". Enter the sequence file name > ").strip()
    st = MenuState(input_file)

    page_i = 0
    while True:
        page = PAGES[page_i]
        _render(st, page, out)
        try:
            ans = readline().strip()
        except EOFError:
            return 1
        if not ans:
            continue
        if ans in ("Y", "y"):
            break
        if ans == "+":
            page_i = (page_i + 1) % len(PAGES)
        elif ans == "-":
            page_i = (page_i - 1) % len(PAGES)
        elif ans in ("Q", "q"):
            return 1
        else:
            try:
                _toggle(st, page, ans, readline)
            except (ValueError, EOFError):
                out.write("\n. Invalid value.\n")

    args = st.to_args()
    if not run:
        launch_interface.last_args = args  # for tests
        return 0
    from phyml_tpu_torch.cli import run_analysis
    return run_analysis(args)
