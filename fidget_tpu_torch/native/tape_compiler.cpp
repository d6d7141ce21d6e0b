// Native host-side tape compiler: .vm text -> register tape.
//
// The C++ analog of the reference's hot host path (SsaTape::new +
// RegisterAllocator, fidget-core/src/compiler/{ssa_tape,alloc}.rs),
// which runs once per shape load here (simplification happens on the
// device). Parses the flat `.vm` format (grammar at
// fidget-core/src/context/mod.rs:861-922) and performs the same
// forward linear-scan LRU register allocation as compiler/lower.py,
// emitting the framework's internal frequency-ordered opcodes.
//
// Exposed through a plain C ABI consumed via ctypes (no pybind11).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// internal TapeOp numbering — keep in sync with compiler/tape.py
enum Op : int32_t {
  OUTPUT = 0, INPUT = 1, COPY = 2,
  MAX = 3, SUB = 4, ADD = 5, MIN = 6, NEG = 7, SQUARE = 8, SQRT = 9,
  MUL = 10, DIV = 11, ABS = 12, EXP = 13, LN = 14, RECIP = 15,
  FLOOR = 16, CEIL = 17, ROUND = 18, NOT = 19,
  AND = 20, OR = 21, MOD = 22, COMPARE = 23, ATAN2 = 24,
  SIN = 25, COS = 26, TAN = 27, ASIN = 28, ACOS = 29, ATAN = 30,
  LOAD = 32, STORE = 33,
};

constexpr int32_t IMM = 0xFF;

struct Node {
  int32_t op;      // Op, or -1 = const, -2 = input
  int32_t a, b;    // operand node ids (-1 unused)
  float imm;       // const value
  int32_t axis;    // input axis 0/1/2
  int32_t uses;
};

struct Row {
  int32_t op, out, a, b, aux;
  float imm;
};

struct Compiler {
  std::vector<Node> nodes;
  std::vector<Row> rows;
  int32_t axis_input[3] = {-1, -1, -1};  // axis -> input index
  int32_t n_inputs = 0;
  std::string error;

  // allocator state
  int reg_limit = 255;
  std::vector<int32_t> reg_of, slot_of, remaining;  // per node
  std::vector<int32_t> reg_node;                    // reg -> node (-1 free)
  std::vector<int64_t> last_touch;                  // reg -> stamp
  std::vector<int32_t> free_regs, free_slots;
  int64_t stamp = 0;
  int32_t mem_count = 0, reg_high = 0, choice_count = 0;

  void touch(int r) { last_touch[r] = ++stamp; }

  int alloc_slot() {
    if (!free_slots.empty()) {
      int s = free_slots.back();
      free_slots.pop_back();
      return s;
    }
    return mem_count++;
  }

  int grab_reg(int forbid1, int forbid2) {
    if (!free_regs.empty()) {
      int r = free_regs.back();
      free_regs.pop_back();
      if (r + 1 > reg_high) reg_high = r + 1;
      return r;
    }
    // evict the least-recently-touched live register
    int victim = -1;
    int64_t best = INT64_MAX;
    for (int r = 0; r < reg_limit; r++) {
      if (r == forbid1 || r == forbid2 || reg_node[r] < 0) continue;
      if (last_touch[r] < best) {
        best = last_touch[r];
        victim = r;
      }
    }
    int node = reg_node[victim];
    reg_node[victim] = -1;
    reg_of[node] = -1;
    if (slot_of[node] < 0) {
      slot_of[node] = alloc_slot();
      rows.push_back({STORE, victim, 0, 0, slot_of[node], 0.0f});
    }
    return victim;
  }

  int ensure_reg(int node, int forbid) {
    if (reg_of[node] >= 0) {
      touch(reg_of[node]);
      return reg_of[node];
    }
    int r = grab_reg(forbid, -1);
    rows.push_back({LOAD, r, 0, 0, slot_of[node], 0.0f});
    reg_of[node] = r;
    reg_node[r] = node;
    touch(r);
    return r;
  }

  void consume(int node) {
    if (--remaining[node] == 0) {
      if (reg_of[node] >= 0) {
        reg_node[reg_of[node]] = -1;
        free_regs.push_back(reg_of[node]);
        reg_of[node] = -1;
      }
      if (slot_of[node] >= 0) {
        free_slots.push_back(slot_of[node]);
        slot_of[node] = -1;
      }
    }
  }

  int define(int node) {
    int r = grab_reg(-1, -1);
    reg_of[node] = r;
    reg_node[r] = node;
    touch(r);
    return r;
  }
};

int32_t unary_op(const std::string& s) {
  if (s == "neg") return NEG;
  if (s == "abs") return ABS;
  if (s == "recip") return RECIP;
  if (s == "sqrt") return SQRT;
  if (s == "square") return SQUARE;
  if (s == "floor") return FLOOR;
  if (s == "ceil") return CEIL;
  if (s == "round") return ROUND;
  if (s == "sin") return SIN;
  if (s == "cos") return COS;
  if (s == "tan") return TAN;
  if (s == "asin") return ASIN;
  if (s == "acos") return ACOS;
  if (s == "atan") return ATAN;
  if (s == "exp") return EXP;
  if (s == "ln") return LN;
  if (s == "not") return NOT;
  return -1;
}

// constant folding with FloatMode semantics (eval/arith.py)
float fold_unary(int32_t op, float a) {
  switch (op) {
    case NEG: return -a;
    case ABS: return fabsf(a);
    case RECIP: return 1.0f / a;
    case SQRT: return sqrtf(a);
    case SQUARE: return a * a;
    case FLOOR: return floorf(a);
    case CEIL: return ceilf(a);
    case ROUND: {
      // |a| >= 2^23: already an integer; the +-0.5 idiom would corrupt
      // odd values (the f32 add rounds ties-to-even) — FloatMode.ROUND
      // has the same guard
      if (fabsf(a) >= 8388608.0f) return a;
      return a >= 0 ? floorf(a + 0.5f) : ceilf(a - 0.5f);
    }
    case NOT: return a == 0.0f ? 1.0f : 0.0f;
    case SIN: return sinf(a);
    case COS: return cosf(a);
    case TAN: return tanf(a);
    case ASIN: return asinf(a);
    case ACOS: return acosf(a);
    case ATAN: return atanf(a);
    case EXP: return expf(a);
    case LN: return logf(a);
  }
  return NAN;
}

float fold_binary(int32_t op, float a, float b) {
  switch (op) {
    case ADD: return a + b;
    case SUB: return a - b;
    case MUL: return a * b;
    case DIV: return a / b;
    case ATAN2: return atan2f(a, b);
    case COMPARE:
      if (std::isnan(a) || std::isnan(b)) return NAN;
      return a < b ? -1.0f : (a > b ? 1.0f : 0.0f);
    case MOD: {  // rem_euclid
      float r = fmodf(a, b);
      return r < 0 ? r + fabsf(b) : r;
    }
    case MIN:
      if (std::isnan(a) || std::isnan(b)) return NAN;
      return a < b ? a : b;
    case MAX:
      if (std::isnan(a) || std::isnan(b)) return NAN;
      return a > b ? a : b;
    case AND: return a == 0.0f ? a : b;
    case OR: return a != 0.0f ? a : b;
  }
  return NAN;
}

int32_t binary_op(const std::string& s) {
  if (s == "add") return ADD;
  if (s == "sub") return SUB;
  if (s == "mul") return MUL;
  if (s == "div") return DIV;
  if (s == "atan2") return ATAN2;
  if (s == "min") return MIN;
  if (s == "max") return MAX;
  if (s == "compare") return COMPARE;
  if (s == "mod") return MOD;
  if (s == "and") return AND;
  if (s == "or") return OR;
  return -1;
}

bool parse(Compiler& c, const char* text) {
  std::unordered_map<std::string, int32_t> seen;
  const char* p = text;
  std::vector<std::string> tok;
  std::string cur;
  int line_no = 0;
  while (true) {
    // read one line
    tok.clear();
    cur.clear();
    bool comment = false;
    while (*p && *p != '\n') {
      char ch = *p++;
      if (ch == '#') comment = true;
      if (comment) continue;
      if (ch == ' ' || ch == '\t' || ch == '\r') {
        if (!cur.empty()) {
          tok.push_back(cur);
          cur.clear();
        }
      } else {
        cur.push_back(ch);
      }
    }
    if (!cur.empty()) tok.push_back(cur);
    line_no++;
    bool done = (*p == 0);
    if (*p) p++;
    if (!tok.empty()) {
      if (tok.size() < 2) {
        c.error = "line " + std::to_string(line_no) + ": malformed";
        return false;
      }
      const std::string& name = tok[0];
      const std::string& opc = tok[1];
      Node n{-1, -1, -1, 0.0f, -1, 0};
      auto ref = [&](const std::string& t, int32_t* out_id) {
        auto it = seen.find(t);
        if (it == seen.end()) {
          c.error = "unknown variable '" + t + "'";
          return false;
        }
        *out_id = it->second;
        return true;
      };
      if (opc == "const") {
        if (tok.size() < 3) { c.error = "const needs a value"; return false; }
        n.op = -1;
        n.imm = strtof(tok[2].c_str(), nullptr);
      } else if (opc == "var-x" || opc == "var-y" || opc == "var-z") {
        n.op = -2;
        n.axis = opc[4] - 'x';
        // input indices are assigned at lower time so that unused
        // axes don't occupy slots (matching lower.py's VarMap order)
      } else {
        int32_t u = unary_op(opc);
        if (u >= 0) {
          if (tok.size() < 3 || !ref(tok[2], &n.a)) {
            if (c.error.empty()) c.error = "unary needs an arg";
            return false;
          }
          n.op = u;
        } else {
          int32_t bop = binary_op(opc);
          if (bop < 0) {
            c.error = "unknown opcode '" + opc + "'";
            return false;
          }
          if (tok.size() < 4 || !ref(tok[2], &n.a) || !ref(tok[3], &n.b)) {
            if (c.error.empty()) c.error = "binary needs two args";
            return false;
          }
          n.op = bop;
        }
      }
      seen[name] = (int32_t)c.nodes.size();
      c.nodes.push_back(n);
    }
    if (done) break;
  }
  if (c.nodes.empty()) {
    c.error = "empty file";
    return false;
  }
  return true;
}

bool lower(Compiler& c) {
  const int N = (int)c.nodes.size();
  const int root = N - 1;  // last definition is the root
  // use counts over the LIVE graph only: a reverse reachability pass
  // from the root (nodes are in definition order, so one backward
  // sweep settles it). Direct counts alone keep subtrees whose only
  // consumer is itself dead — .vm context dumps can contain
  // unreachable definitions (the Python path prunes them via
  // topological_order(roots)); worse, the skipped dead consumer never
  // consume()s, pinning its operands' registers for the whole tape.
  std::vector<char> live(N, 0);
  live[root] = 1;
  for (int i = N - 1; i >= 0; i--) {
    if (!live[i]) continue;
    Node& n = c.nodes[i];
    if (n.a >= 0) live[n.a] = 1;
    if (n.op >= 0 && n.b >= 0) live[n.b] = 1;
  }
  c.remaining.assign(N, 0);
  for (int i = 0; i < N; i++) {
    if (!live[i]) continue;
    Node& n = c.nodes[i];
    if (n.a >= 0) c.remaining[n.a]++;
    if (n.op >= 0 && n.b >= 0) c.remaining[n.b]++;
  }
  c.remaining[root]++;  // OUTPUT consumes the root
  c.reg_of.assign(N, -1);
  c.slot_of.assign(N, -1);
  c.reg_node.assign(c.reg_limit, -1);
  c.last_touch.assign(c.reg_limit, -1);
  c.free_regs.clear();
  for (int r = c.reg_limit - 1; r >= 0; r--) c.free_regs.push_back(r);

  for (int i = 0; i < N; i++) {
    Node& n = c.nodes[i];
    if (n.op == -1) continue;  // constants are immediates
    if (c.remaining[i] == 0) continue;  // dead subexpression
    if (n.op == -2) {
      if (c.axis_input[n.axis] < 0) c.axis_input[n.axis] = c.n_inputs++;
      int r = c.define(i);
      c.rows.push_back({INPUT, r, 0, 0, c.axis_input[n.axis], 0.0f});
      continue;
    }
    bool is_choice = (n.op == MIN || n.op == MAX || n.op == AND || n.op == OR);
    if (n.b < 0) {  // unary
      if (c.nodes[n.a].op == -1) {
        // constant fold, like Context::op_unary on the Python path
        n.imm = fold_unary(n.op, c.nodes[n.a].imm);
        n.op = -1;
        continue;
      }
      int ra = c.ensure_reg(n.a, -1);
      c.consume(n.a);
      int ro = c.define(i);
      c.rows.push_back({n.op, ro, ra, 0, 0, 0.0f});
    } else {
      bool ca = c.nodes[n.a].op == -1;
      bool cb = c.nodes[n.b].op == -1;
      if (ca && cb) {
        n.imm = fold_binary(n.op, c.nodes[n.a].imm, c.nodes[n.b].imm);
        n.op = -1;
        continue;
      }
      if (is_choice) c.choice_count++;
      if (ca) {
        int rb = c.ensure_reg(n.b, -1);
        c.consume(n.b);
        int ro = c.define(i);
        c.rows.push_back({n.op, ro, IMM, rb, 0, c.nodes[n.a].imm});
      } else if (cb) {
        int ra = c.ensure_reg(n.a, -1);
        c.consume(n.a);
        int ro = c.define(i);
        c.rows.push_back({n.op, ro, ra, IMM, 0, c.nodes[n.b].imm});
      } else {
        int ra = c.ensure_reg(n.a, -1);
        int rb = c.ensure_reg(n.b, ra);
        c.consume(n.a);
        c.consume(n.b);
        int ro = c.define(i);
        c.rows.push_back({n.op, ro, ra, rb, 0, 0.0f});
      }
    }
  }
  // OUTPUT for the root
  if (c.nodes[root].op == -1) {
    int r = c.define(root);
    c.rows.push_back({COPY, r, IMM, 0, 0, c.nodes[root].imm});
    c.rows.push_back({OUTPUT, r, 0, 0, 0, 0.0f});
  } else {
    int r = c.ensure_reg(root, -1);
    c.rows.push_back({OUTPUT, r, 0, 0, 0, 0.0f});
  }
  c.consume(root);
  return true;
}

}  // namespace

extern "C" {

struct FidgetTape {
  int32_t n_ops;
  int32_t reg_count;
  int32_t mem_count;
  int32_t choice_count;
  int32_t n_inputs;
  int32_t axis_input[3];
  int32_t* op;
  int32_t* out;
  int32_t* a;
  int32_t* b;
  float* imm;
  int32_t* aux;
  char error[256];
};

FidgetTape* fidget_compile_vm(const char* text, int reg_limit) {
  auto* t = (FidgetTape*)calloc(1, sizeof(FidgetTape));
  Compiler c;
  if (reg_limit >= 2 && reg_limit <= 255) {
    c.reg_limit = reg_limit;
  } else {
    // same contract as the Python path (lower.py raises ValueError)
    snprintf(t->error, sizeof(t->error),
             "reg_limit must be in [2, 255], got %d", reg_limit);
    return t;
  }
  if (!parse(c, text) || !lower(c)) {
    snprintf(t->error, sizeof(t->error), "%s", c.error.c_str());
    return t;
  }
  int n = (int)c.rows.size();
  t->n_ops = n;
  t->reg_count = c.reg_high;
  t->mem_count = c.mem_count;
  t->choice_count = c.choice_count;
  t->n_inputs = c.n_inputs;
  memcpy(t->axis_input, c.axis_input, sizeof(t->axis_input));
  t->op = (int32_t*)malloc(n * 4);
  t->out = (int32_t*)malloc(n * 4);
  t->a = (int32_t*)malloc(n * 4);
  t->b = (int32_t*)malloc(n * 4);
  t->imm = (float*)malloc(n * 4);
  t->aux = (int32_t*)malloc(n * 4);
  for (int i = 0; i < n; i++) {
    t->op[i] = c.rows[i].op;
    t->out[i] = c.rows[i].out;
    t->a[i] = c.rows[i].a;
    t->b[i] = c.rows[i].b;
    t->imm[i] = c.rows[i].imm;
    t->aux[i] = c.rows[i].aux;
  }
  return t;
}

void fidget_free_tape(FidgetTape* t) {
  if (!t) return;
  free(t->op);
  free(t->out);
  free(t->a);
  free(t->b);
  free(t->imm);
  free(t->aux);
  free(t);
}

}  // extern "C"
