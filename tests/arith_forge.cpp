// Arithmetic-coded JPEG scans for tests/image_forge.py: the QM encoder of
// T.81 Annex D and the DC / AC coding models of Annex F.1.4 and G.1.3, laid
// out as libjpeg's jcarith.c lays them out (statistics bins per table slot,
// DAC conditioning, restart intervals). No tool writes such files (neither
// cv2 nor PIL encodes arithmetic coding), so the tests make them here from
// quantised coefficients. It shares nothing with the port's decoder.
//
// C interface (ctypes): pv_arith_scan(...) codes one scan of the given
// components into out and returns its length (-1 when cap is too small).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// T.81 Table D.2 as (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
const uint16_t kQe[113] = {
    0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d,
    0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1,
    0x072f, 0x055c, 0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068,
    0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518,
    0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4,
    0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12, 0x4d04,
    0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b,
    0x0d51, 0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516,
    0x5570, 0x4ca9, 0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf,
    0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f,
    0x5a10, 0x5522, 0x59eb};
const uint8_t kNextLps[113] = {
    1,  14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9,  10, 12, 15, 36, 38, 39, 40, 42, 43, 45, 46,
    48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74,
    75, 77, 78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83,
    84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97,
    99, 99, 93, 95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110,
    112, 112};
const uint8_t kNextMps[113] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 13, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9,  37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
    47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69,
    70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87, 71, 89, 90, 91, 92,
    93, 94, 86, 96, 97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111, 109,
    111};
const uint8_t kSwitch[113] = {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0,
                              0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1};

// A probability state: the index into Table D.2 and the MPS. The fixed 0.5
// estimate (T.851) is the state FIXED, which never moves.
constexpr int FIXED = 113;
struct Bin {
  uint8_t index = 0, mps = 0;
};

// Annex D.1: the encoder's C and A registers, the byte buffer and the
// stacked 0xFF (sc) and pending zero (zc) bytes
struct Coder {
  std::vector<uint8_t>& out;
  int64_t c = 0, a = 0x10000, sc = 0, zc = 0;
  int ct = 11, buffer = -1;

  explicit Coder(std::vector<uint8_t>& o) : out(o) {}
  void emit(int b) { out.push_back((uint8_t)b); }
  void zeros() {
    for (; zc; zc--) emit(0x00);
  }
  void byte_out() {   // D.1.6 Byte_out with carry propagation
    int64_t temp = c >> 19;
    if (temp > 0xFF) {
      if (buffer >= 0) {
        zeros();
        emit(buffer + 1);
        if (buffer + 1 == 0xFF) emit(0x00);
      }
      zc += sc;
      sc = 0;
      buffer = (int)(temp & 0xFF);
    } else if (temp == 0xFF) {
      sc++;
    } else {
      if (buffer == 0) {
        zc++;
      } else if (buffer >= 0) {
        zeros();
        emit(buffer);
      }
      if (sc) {
        zeros();
        for (; sc; sc--) {
          emit(0xFF);
          emit(0x00);
        }
      }
      buffer = (int)(temp & 0xFF);
    }
    c &= 0x7FFFF;
    ct += 8;
  }
  void code(Bin& st, int val) {   // D.1.2-D.1.5
    const bool fixed = st.index == FIXED;
    const int64_t qe = fixed ? 0x5a1d : kQe[st.index];
    a -= qe;
    if (val != st.mps) {   // LPS
      if (a >= qe) {
        c += a;
        a = qe;
      }
      if (!fixed) {
        if (kSwitch[st.index]) st.mps ^= 1;
        st.index = kNextLps[st.index];
      }
    } else {               // MPS
      if (a >= 0x8000) return;
      if (a < qe) {
        c += a;
        a = qe;
      }
      if (!fixed) st.index = kNextMps[st.index];
    }
    do {   // D.1.6 renormalisation
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byte_out();
    } while (a < 0x8000);
  }
  void flush() {   // D.1.8: the C in the final interval with the most trailing zeros
    int64_t temp = (a - 1 + c) & 0xFFFF0000LL;
    c = temp < c ? temp + 0x8000 : temp;
    c <<= ct;
    if (c & 0xF8000000LL) {
      if (buffer >= 0) {
        zeros();
        emit(buffer + 1);
        if (buffer + 1 == 0xFF) emit(0x00);
      }
      zc += sc;
      sc = 0;
    } else {
      if (buffer == 0) {
        zc++;
      } else if (buffer >= 0) {
        zeros();
        emit(buffer);
      }
      if (sc) {
        zeros();
        for (; sc; sc--) {
          emit(0xFF);
          emit(0x00);
        }
      }
    }
    if (c & 0x7FFF800LL) {   // the final bytes, unless they are zero
      zeros();
      emit((int)((c >> 19) & 0xFF));
      if (((c >> 19) & 0xFF) == 0xFF) emit(0x00);
      if (c & 0x7F800LL) {
        emit((int)((c >> 11) & 0xFF));
        if (((c >> 11) & 0xFF) == 0xFF) emit(0x00);
      }
    }
    c = 0;
    a = 0x10000;
    sc = zc = 0;
    ct = 11;
    buffer = -1;
  }
};

struct Model {
  Bin dc[16][64], ac[16][256];
  Bin fixed;
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  const uint8_t *L, *U, *K;
  Model() { fixed.index = FIXED; }
};

// F.1.4.1 / F.1.4.4.1: a DC difference in table slot tbl, component ci
void code_dc(Coder& e, Model& s, int ci, int tbl, int v) {
  Bin* st = s.dc[tbl] + s.dc_context[ci];
  if (v == 0) {
    e.code(*st, 0);
    s.dc_context[ci] = 0;
    return;
  }
  e.code(*st, 1);
  int sign = v < 0;
  if (sign) v = -v;
  e.code(st[1], sign);
  st += 2 + sign;
  s.dc_context[ci] = 4 + 4 * sign;
  int m = 0;
  if ((v -= 1)) {
    e.code(*st, 1);
    m = 1;
    int v2 = v;
    st = s.dc[tbl] + 20;
    while (v2 >>= 1) {
      e.code(*st, 1);
      m <<= 1;
      st++;
    }
  }
  e.code(*st, 0);
  if (m < ((1 << s.L[tbl]) >> 1)) s.dc_context[ci] = 0;
  else if (m > ((1 << s.U[tbl]) >> 1)) s.dc_context[ci] += 8;
  st += 14;
  while (m >>= 1) e.code(*st, (m & v) ? 1 : 0);
}

// F.1.4.2 (Figure F.5): coefficients ss..se (zigzag order) after the point
// transform al
void code_ac(Coder& e, Model& s, int tbl, const int16_t* b, int ss, int se, int al) {
  auto mag = [&](int k) {
    int v = b[k];
    return v >= 0 ? v >> al : -((-v) >> al);
  };
  int ke = se;
  while (ke >= ss && mag(ke) == 0) ke--;
  int k = ss;
  for (; k <= ke; k++) {
    Bin* st = s.ac[tbl] + 3 * (k - 1);
    e.code(*st, 0);   // not EOB
    while (mag(k) == 0) {
      e.code(st[1], 0);
      st += 3;
      k++;
    }
    e.code(st[1], 1);
    int v = mag(k);
    e.code(s.fixed, v < 0);
    if (v < 0) v = -v;
    st += 2;
    int m = 0;
    if ((v -= 1)) {
      e.code(*st, 1);
      m = 1;
      int v2 = v;
      if (v2 >>= 1) {
        e.code(*st, 1);
        m <<= 1;
        st = s.ac[tbl] + (k <= s.K[tbl] ? 189 : 217);
        while (v2 >>= 1) {
          e.code(*st, 1);
          m <<= 1;
          st++;
        }
      }
    }
    e.code(*st, 0);
    st += 14;
    while (m >>= 1) e.code(*st, (m & v) ? 1 : 0);
  }
  if (k <= se) e.code(s.ac[tbl][3 * (k - 1)], 1);   // EOB
}

// G.1.3.3 (Figure G.10): the refinement of coefficients ss..se at bit al
void code_ac_refine(Coder& e, Model& s, int tbl, const int16_t* b, int ss, int se, int al) {
  auto shifted = [&](int k, int by) {
    int v = b[k];
    return v >= 0 ? v >> by : (-v) >> by;
  };
  int ke = se;
  while (ke > 0 && shifted(ke, al) == 0) ke--;
  int kex = ke;   // the previous stage's end of block
  while (kex > 0 && shifted(kex, al + 1) == 0) kex--;
  int k = ss;
  for (; k <= ke; k++) {
    Bin* st = s.ac[tbl] + 3 * (k - 1);
    if (k > kex) e.code(*st, 0);   // not EOB
    for (;;) {
      int v = shifted(k, al);
      if (v) {
        if (v >> 1) {
          e.code(st[2], v & 1);   // a bit of a coefficient already nonzero
        } else {
          e.code(st[1], 1);       // newly nonzero
          e.code(s.fixed, b[k] < 0);
        }
        break;
      }
      e.code(st[1], 0);
      st += 3;
      k++;
    }
  }
  if (k <= se) e.code(s.ac[tbl][3 * (k - 1)], 1);   // EOB
}

}  // namespace

extern "C" {

// One scan. coefs[i]: component i's (pbh, pbw, 64) zigzag-order
// coefficients; geom[7 i ..]: its h, v, bw, bh, pbw and the DC and AC table
// slots. kind: 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC
// refine (one component). restart: the interval in MCUs (0: none). L, U,
// K: the conditioning of the 16 table slots.
long pv_arith_scan(int ncomp, const int16_t* const* coefs, const int* geom, int mcux, int mcuy,
                   int kind, int ss, int se, int al, int restart, const uint8_t* L,
                   const uint8_t* U, const uint8_t* K, uint8_t* out, long cap) {
  std::vector<uint8_t> buf;
  Coder e(buf);
  Model* s = new Model();
  s->L = L;
  s->U = U;
  s->K = K;
  auto reset = [&] {
    for (int i = 0; i < ncomp; i++) {
      const int* g = geom + 7 * i;
      if (kind <= 1) {
        memset(s->dc[g[5]], 0, sizeof s->dc[0]);
        s->last_dc[i] = s->dc_context[i] = 0;
      }
      if (kind == 0 || kind >= 3) memset(s->ac[g[6]], 0, sizeof s->ac[0]);
    }
  };
  reset();
  const bool one = ncomp == 1;
  const int nx = one ? geom[2] : mcux, ny = one ? geom[3] : mcuy;
  long mcu = 0;
  for (int my = 0; my < ny; my++)
    for (int mx = 0; mx < nx; mx++, mcu++) {
      if (restart && mcu && mcu % restart == 0) {
        e.flush();
        e.emit(0xFF);
        e.emit(0xD0 + (int)((mcu / restart - 1) % 8));
        reset();
      }
      for (int i = 0; i < ncomp; i++) {
        const int* g = geom + 7 * i;
        const int nh = one ? 1 : g[0], nv = one ? 1 : g[1];
        for (int by = 0; by < nv; by++)
          for (int bx = 0; bx < nh; bx++) {
            const int16_t* b = coefs[i] + ((size_t)(my * nv + by) * g[4] + mx * nh + bx) * 64;
            switch (kind) {
              case 0:
                code_dc(e, *s, i, g[5], b[0] - s->last_dc[i]);
                s->last_dc[i] = b[0];
                code_ac(e, *s, g[6], b, 1, 63, 0);
                break;
              case 1: {
                int m = b[0] >> al;   // arithmetic shift
                code_dc(e, *s, i, g[5], m - s->last_dc[i]);
                s->last_dc[i] = m;
                break;
              }
              case 2:
                e.code(s->fixed, (b[0] >> al) & 1);
                break;
              case 3:
                code_ac(e, *s, g[6], b, ss, se, al);
                break;
              default:
                code_ac_refine(e, *s, g[6], b, ss, se, al);
                break;
            }
          }
      }
    }
  e.flush();
  delete s;
  if ((long)buf.size() > cap) return -1;
  memcpy(out, buf.data(), buf.size());
  return (long)buf.size();
}

}  // extern "C"
