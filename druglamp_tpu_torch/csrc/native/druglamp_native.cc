// druglamp_native — C++ host-side featurization runtime (the port's copy of
// the JAX package's native/csrc/druglamp_native.cc; the code below the
// header is the same).
//
// Replaces the reference's native dependency surface for the input pipeline
// (RDKit C++ SMILES parsing + dgllife featurization + DGL graph batching;
// reference handler/dataset.py:46-48,213-222).  Exposes a C ABI consumed via
// ctypes (druglamp_tpu_torch/chem/native.py):
//
//   dl_parse_featurize : SMILES → 74-dim canonical atom features + bond list
//   dl_assemble_batch  : per-batch dense adjacency + degree packing (memset +
//                        scatter, OpenMP across the batch)
//
// The molecular perception model mirrors druglamp_tpu_torch/chem/smiles.py
// (the Python implementation is the behavioural reference; the two are
// cross-tested in tests/test_torch_port_native_dense.py).
//
// Build: at first use by druglamp_tpu_torch/chem/native.py
// (g++ -O3 -fPIC -shared -std=c++17 -Wall -fopenmp, into _build/).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Atom {
  std::string symbol;
  bool aromatic = false;
  int charge = 0;
  int explicit_h = -1;  // -1 = implicit model
  int isotope = 0;
  int smiles_pos = -1;
  // perception
  int degree = 0;
  int implicit_h = 0;
  int total_h = 0;
  int radicals = 0;
  int hyb = 2;  // 0 SP,1 SP2,2 SP3,3 SP3D,4 SP3D2,-1 other(S)
};

struct Bond {
  int a, b;
  double order;  // 1,2,3,4 or 1.5 aromatic
};

struct Mol {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
};

const char* kElements[] = {
    "He", "Li", "Be", "Ne", "Na", "Mg", "Al", "Si", "Cl", "Ar", "Ca", "Sc",
    "Ti", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se",
    "Br", "Kr", "Rb", "Sr", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag",
    "Cd", "In", "Sn", "Sb", "Te", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf",
    "Ta", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr", "H",  "B",  "C",  "N",  "O",  "F",  "P",
    "S",  "K",  "V",  "Y",  "I",  "W",  "U"};

bool match_element(const std::string& s, size_t i, std::string* out) {
  // longest (2-char) first
  for (const char* el : kElements) {
    size_t n = std::strlen(el);
    if (n == 2 && s.compare(i, 2, el) == 0) { *out = el; return true; }
  }
  for (const char* el : kElements) {
    size_t n = std::strlen(el);
    if (n == 1 && s.compare(i, 1, el) == 0) { *out = el; return true; }
  }
  return false;
}

// Daylight default valences
bool default_valences(const std::string& sym, std::vector<int>* out) {
  if (sym == "B") *out = {3};
  else if (sym == "C") *out = {4};
  else if (sym == "N") *out = {3, 5};
  else if (sym == "O") *out = {2};
  else if (sym == "P") *out = {3, 5};
  else if (sym == "S") *out = {2, 4, 6};
  else if (sym == "F" || sym == "Cl" || sym == "Br" || sym == "I") *out = {1};
  else return false;
  return true;
}

std::vector<int> charge_adjusted(const Atom& a, std::vector<int> v) {
  if (v.empty() || a.charge == 0) return v;
  const std::string& sym = a.symbol;
  int ch = a.charge;
  if ((sym == "N" || sym == "P" || sym == "O" || sym == "S") && ch > 0) {
    for (int& x : v) x += ch;
    return v;
  }
  if (ch < 0) {
    for (int& x : v) x = std::max(0, x + ch);
    return v;
  }
  if (sym == "C" || sym == "B") {
    for (int& x : v) x = std::max(0, x - std::abs(ch));
    return v;
  }
  return v;
}

double bond_symbol_order(char c) {
  switch (c) {
    case '-': case '/': case '\\': return 1.0;
    case '=': return 2.0;
    case '#': return 3.0;
    case '$': return 4.0;
    case ':': return 1.5;
  }
  return 0.0;
}

// returns false + error message on parse failure
bool parse_bracket(const std::string& s, size_t* ip, Mol* mol, Atom* atom,
                   std::string* err) {
  size_t j = *ip + 1;
  int isotope = 0;
  while (j < s.size() && std::isdigit((unsigned char)s[j]))
    isotope = isotope * 10 + (s[j++] - '0');
  std::string sym;
  bool aromatic = false;
  if (s.compare(j, 2, "se") == 0) { sym = "Se"; aromatic = true; j += 2; }
  else if (s.compare(j, 2, "as") == 0) { sym = "As"; aromatic = true; j += 2; }
  else if (s.compare(j, 2, "te") == 0) { sym = "Te"; aromatic = true; j += 2; }
  else if (s.compare(j, 2, "si") == 0) { sym = "Si"; aromatic = true; j += 2; }
  else if (j < s.size() && std::strchr("bcnops", s[j])) {
    sym = std::string(1, std::toupper((unsigned char)s[j]));
    aromatic = true;
    ++j;
  } else {
    std::string el;
    if (match_element(s, j, &el)) { sym = el; j += el.size(); }
    else if (j < s.size() && s[j] == '*') { sym = "*"; ++j; }
    else { *err = "bad bracket atom"; return false; }
  }
  size_t sym_pos = j - sym.size();
  while (j < s.size() && s[j] == '@') ++j;
  if (s.compare(j, 2, "TH") == 0) j += 2;
  int explicit_h = 0;
  if (j < s.size() && s[j] == 'H') {
    ++j;
    explicit_h = 1;
    if (j < s.size() && std::isdigit((unsigned char)s[j]))
      explicit_h = s[j++] - '0';
  }
  int charge = 0;
  while (j < s.size() && (s[j] == '+' || s[j] == '-')) {
    int sign = s[j] == '+' ? 1 : -1;
    ++j;
    if (j < s.size() && std::isdigit((unsigned char)s[j])) {
      int n = 0;
      while (j < s.size() && std::isdigit((unsigned char)s[j]))
        n = n * 10 + (s[j++] - '0');
      charge += sign * n;
    } else {
      charge += sign;
    }
  }
  if (j < s.size() && s[j] == ':') {
    ++j;
    while (j < s.size() && std::isdigit((unsigned char)s[j])) ++j;
  }
  if (j >= s.size() || s[j] != ']') { *err = "unterminated bracket"; return false; }
  atom->symbol = sym;
  atom->aromatic = aromatic;
  atom->charge = charge;
  atom->explicit_h = explicit_h;
  atom->isotope = isotope;
  atom->smiles_pos = (int)sym_pos;
  *ip = j + 1;
  return true;
}

int add_atom(Mol* mol, Atom atom, int prev, double pending) {
  int idx = (int)mol->atoms.size();
  mol->atoms.push_back(std::move(atom));
  if (prev >= 0) {
    double order = pending;
    if (order == 0.0)
      order = (mol->atoms[prev].aromatic && mol->atoms[idx].aromatic) ? 1.5 : 1.0;
    mol->bonds.push_back({prev, idx, order});
  }
  return idx;
}

bool parse_smiles(const std::string& s, Mol* mol, std::string* err) {
  std::vector<int> stack;
  int prev = -1;
  double pending = 0.0;  // 0 = none
  std::unordered_map<int, std::pair<int, double>> ring_open;
  size_t i = 0;
  const size_t n = s.size();
  while (i < n) {
    char c = s[i];
    if (c == '[') {
      Atom atom;
      if (!parse_bracket(s, &i, mol, &atom, err)) return false;
      prev = add_atom(mol, atom, prev, pending);
      pending = 0.0;
    } else if (bond_symbol_order(c) != 0.0) {
      if (pending != 0.0 && c != '/' && c != '\\') { *err = "double bond symbol"; return false; }
      pending = bond_symbol_order(c);
      ++i;
    } else if (c == '(') {
      if (prev < 0) { *err = "branch with no prior atom"; return false; }
      stack.push_back(prev);
      ++i;
    } else if (c == ')') {
      if (stack.empty()) { *err = "unbalanced ')'"; return false; }
      prev = stack.back();
      stack.pop_back();
      ++i;
    } else if (c == '.') {
      prev = -1;
      pending = 0.0;
      ++i;
    } else if (std::isdigit((unsigned char)c) || c == '%') {
      int num;
      if (c == '%') {
        if (i + 2 >= n || !std::isdigit((unsigned char)s[i + 1]) ||
            !std::isdigit((unsigned char)s[i + 2])) {
          *err = "bad %ring closure";
          return false;
        }
        num = (s[i + 1] - '0') * 10 + (s[i + 2] - '0');
        i += 3;
      } else {
        num = c - '0';
        ++i;
      }
      if (prev < 0) { *err = "ring closure with no prior atom"; return false; }
      auto it = ring_open.find(num);
      if (it != ring_open.end()) {
        int other = it->second.first;
        double opened = it->second.second;
        ring_open.erase(it);
        double order = pending != 0.0 ? pending : opened;
        if (order == 0.0)
          order = (mol->atoms[prev].aromatic && mol->atoms[other].aromatic) ? 1.5 : 1.0;
        mol->bonds.push_back({other, prev, order});
        pending = 0.0;
      } else {
        ring_open[num] = {prev, pending};
        pending = 0.0;
      }
    } else if (s.compare(i, 2, "Cl") == 0 || s.compare(i, 2, "Br") == 0) {
      Atom atom;
      atom.symbol = s.substr(i, 2);
      atom.smiles_pos = (int)i;
      i += 2;
      prev = add_atom(mol, atom, prev, pending);
      pending = 0.0;
    } else if (std::strchr("bcnops", c)) {
      Atom atom;
      atom.symbol = std::string(1, std::toupper((unsigned char)c));
      atom.aromatic = true;
      atom.smiles_pos = (int)i;
      ++i;
      prev = add_atom(mol, atom, prev, pending);
      pending = 0.0;
    } else if (std::strchr("BCNOPSFI", c)) {
      Atom atom;
      atom.symbol = std::string(1, c);
      atom.smiles_pos = (int)i;
      ++i;
      prev = add_atom(mol, atom, prev, pending);
      pending = 0.0;
    } else if (c == '*') {
      Atom atom;
      atom.symbol = "*";
      atom.smiles_pos = (int)i;
      ++i;
      prev = add_atom(mol, atom, prev, pending);
      pending = 0.0;
    } else if (c == ' ' || c == '\t') {
      break;
    } else {
      *err = std::string("unexpected char '") + c + "'";
      return false;
    }
  }
  if (!ring_open.empty()) { *err = "unclosed ring bonds"; return false; }
  if (!stack.empty()) { *err = "unclosed branches"; return false; }
  return true;
}

void perceive(Mol* mol) {
  const int n = (int)mol->atoms.size();
  std::vector<double> bond_sum(n, 0.0), max_order(n, 0.0);
  std::vector<int> arom_bonds(n, 0), n_double(n, 0), degree(n, 0);
  for (const Bond& bd : mol->bonds) {
    const int ends[2] = {bd.a, bd.b};
    for (int e : ends) {
      degree[e] += 1;
      if (bd.order == 1.5) {
        arom_bonds[e] += 1;
        bond_sum[e] += 1.0;
      } else {
        bond_sum[e] += bd.order;
        if (bd.order == 2.0) n_double[e] += 1;
      }
      if (bd.order > max_order[e]) max_order[e] = bd.order;
    }
  }
  for (int i = 0; i < n; ++i) {
    Atom& a = mol->atoms[i];
    a.degree = degree[i];
    double ev = bond_sum[i];
    if (a.aromatic && arom_bonds[i] >= 2) ev += 1.0;  // Kekulé double bond
    int ev_int = (int)std::lround(ev);

    std::vector<int> vals;
    bool has_vals = default_valences(a.symbol, &vals);
    if (a.explicit_h >= 0) {
      a.implicit_h = 0;
      a.total_h = a.explicit_h;
      std::vector<int> target =
          has_vals ? charge_adjusted(a, vals) : std::vector<int>{};
      int used = ev_int + a.explicit_h;
      int rad = 0;
      for (int t : target) {
        if (used <= t) { rad = t - used; break; }
      }
      a.radicals = (!target.empty() && used < target.front()) ? rad : 0;
    } else {
      std::vector<int> target =
          has_vals ? charge_adjusted(a, vals) : std::vector<int>{};
      int h = 0;
      for (int t : target) {
        if (ev_int <= t) { h = t - ev_int; break; }
      }
      a.implicit_h = h > 0 ? h : 0;
      a.total_h = a.implicit_h;
      a.radicals = 0;
    }

    if (a.aromatic) a.hyb = 1;                       // SP2
    else if (max_order[i] >= 3.0 || n_double[i] >= 2) a.hyb = 0;  // SP
    else if (n_double[i] == 1) a.hyb = 1;            // SP2
    else if (degree[i] == 0 && a.total_h == 0) a.hyb = -1;  // bare ion
    else a.hyb = 2;                                  // SP3
  }
}

// dgllife CanonicalAtomFeaturizer symbol order (43)
const char* kFeatSymbols[] = {
    "C",  "N",  "O", "S",  "F",  "Si", "P",  "Cl", "Br", "Mg", "Na",
    "Ca", "Fe", "As", "Al", "I",  "B",  "V",  "K",  "Tl", "Yb", "Sb",
    "Sn", "Ag", "Pd", "Co", "Se", "Ti", "Zn", "H",  "Li", "Ge", "Cu",
    "Au", "Ni", "Cd", "In", "Mn", "Zr", "Cr", "Pt", "Hg", "Pb"};
constexpr int kNumSymbols = 43;
constexpr int kFeatDim = 74;  // 43+11+7+1+1+5+1+5

void atom_features(const Atom& a, float* out) {
  std::memset(out, 0, sizeof(float) * kFeatDim);
  for (int i = 0; i < kNumSymbols; ++i) {
    if (a.symbol == kFeatSymbols[i]) { out[i] = 1.0f; break; }
  }
  int col = kNumSymbols;
  if (a.degree >= 0 && a.degree <= 10) out[col + a.degree] = 1.0f;
  col += 11;
  if (a.implicit_h >= 0 && a.implicit_h <= 6) out[col + a.implicit_h] = 1.0f;
  col += 7;
  out[col++] = (float)a.charge;
  out[col++] = (float)a.radicals;
  if (a.hyb >= 0 && a.hyb <= 4) out[col + a.hyb] = 1.0f;
  col += 5;
  out[col++] = a.aromatic ? 1.0f : 0.0f;
  if (a.total_h >= 0 && a.total_h <= 4) out[col + a.total_h] = 1.0f;
}

}  // namespace

extern "C" {

// Parse + featurize one SMILES.
//   node_feats: caller buffer (max_nodes × 74) floats
//   edges:      caller buffer (2 × max_edges) int32 (directed pairs, both dirs)
// Returns 0 ok; 1 parse error (err filled); 2 too many atoms; 3 too many edges.
int dl_parse_featurize(const char* smiles, int max_nodes, int max_edges,
                       float* node_feats, int32_t* edges, int32_t* n_atoms,
                       int32_t* n_edges, char* err, int err_len) {
  Mol mol;
  std::string e;
  if (!parse_smiles(smiles ? smiles : "", &mol, &e)) {
    std::snprintf(err, err_len, "%s", e.c_str());
    return 1;
  }
  perceive(&mol);
  const int n = (int)mol.atoms.size();
  if (n > max_nodes) return 2;
  const int m = (int)mol.bonds.size() * 2;
  if (m > max_edges) return 3;
  for (int i = 0; i < n; ++i)
    atom_features(mol.atoms[i], node_feats + (size_t)i * kFeatDim);
  int k = 0;
  for (const Bond& bd : mol.bonds) {
    edges[k] = bd.a;
    edges[max_edges + k] = bd.b;
    ++k;
    edges[k] = bd.b;
    edges[max_edges + k] = bd.a;
    ++k;
  }
  *n_atoms = n;
  *n_edges = m;
  return 0;
}

// Assemble a batch of dense adjacencies + degrees from packed edge lists.
//   edges: (total_edges, 2) int32; offsets: (B+1,) int32 into edges
//   n_atoms: (B,) int32
//   adj: (B, N, N) uint8 zeroed-or-not (we overwrite fully)
//   degrees: (B, N) float
// Self-loop convention: 2 on real-atom diagonal, 1 on virtual (reference
// double add_self_loop; handler/dataset.py:213-222).
void dl_assemble_batch(int B, int N, const int32_t* edges,
                       const int32_t* offsets, const int32_t* n_atoms,
                       uint8_t* adj, float* degrees) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int b = 0; b < B; ++b) {
    uint8_t* A = adj + (size_t)b * N * N;
    std::memset(A, 0, (size_t)N * N);
    for (int32_t k = offsets[b]; k < offsets[b + 1]; ++k) {
      int32_t u = edges[(size_t)k * 2];
      int32_t v = edges[(size_t)k * 2 + 1];
      A[(size_t)u * N + v] = 1;
    }
    const int na = n_atoms[b];
    for (int i = 0; i < N; ++i) A[(size_t)i * N + i] = i < na ? 2 : 1;
    float* deg = degrees + (size_t)b * N;
    for (int i = 0; i < N; ++i) {
      int s = 0;
      const uint8_t* row = A + (size_t)i * N;
      for (int j = 0; j < N; ++j) s += row[j];
      deg[i] = (float)s;
    }
  }
}

int dl_feature_dim() { return kFeatDim; }

}  // extern "C"
